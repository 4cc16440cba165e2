"""Examples of the port's API, run with ``python -m
fdeflate_tpu_torch.examples.<name>``."""
