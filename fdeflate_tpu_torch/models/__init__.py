"""The host streaming codec: compressor levels 0-9, the ultra-fast PNG
mode, the resumable decompressor and the native C++ backend's loader
(copies of ``fdeflate_tpu/models/``, numpy only; the decompressor's
whole-buffer route reaches the card through ``parallel/discovery``)."""
