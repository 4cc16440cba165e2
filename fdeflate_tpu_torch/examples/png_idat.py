"""PNG IDAT recompression example — the reference's flagship use case.

The port's copy of ``examples/png_idat.py``.  Reads a PNG, extracts and
re-deflates its IDAT stream with the ultra-fast encoder (or any level), and
writes a valid PNG back: the host API end to end on real image data.  With
many files, ``fdeflate_tpu_torch.compress_batch_ultra_fast`` compresses
all IDATs in one batch on the card.

Usage: python -m fdeflate_tpu_torch.examples.png_idat input.png output.png
       [level|uf] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import struct
import zlib

import fdeflate_tpu_torch as P


def read_chunks(data: bytes):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        yield ctype, payload
        pos += 12 + length


def write_chunk(out: bytearray, ctype: bytes, payload: bytes):
    out += struct.pack(">I", len(payload))
    out += ctype
    out += payload
    out += struct.pack(">I", zlib.crc32(ctype + payload))


def recompress(png: bytes, mode: str = "uf", *, device="cuda") -> bytes:
    """``png`` with its IDAT stream decoded and encoded again by ``mode``
    ("uf" for the ultra-fast encoder, else a level 0-9).  ``device`` is
    where a large IDAT decodes when the native backend is unavailable."""
    idat = b"".join(p for c, p in read_chunks(png) if c == b"IDAT")
    raw = P.decompress_to_vec(idat, device=device)
    if mode == "uf":
        new_idat = P.compress_to_vec_ultra_fast(raw)
    else:
        new_idat = P.compress_to_vec_with_level(raw, int(mode))

    out = bytearray(b"\x89PNG\r\n\x1a\n")
    wrote_idat = False
    for ctype, payload in read_chunks(png):
        if ctype == b"IDAT":
            if not wrote_idat:
                write_chunk(out, b"IDAT", new_idat)
                wrote_idat = True
            continue
        write_chunk(out, ctype, payload)
    return bytes(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("mode", nargs="?", default="uf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(args.src, "rb") as f:
        png = f.read()
    result = recompress(png, args.mode, device=args.device)
    with open(args.dst, "wb") as f:
        f.write(result)
    print(f"{args.src}: {len(png)} -> {len(result)} bytes ({args.mode})")


if __name__ == "__main__":
    main()
