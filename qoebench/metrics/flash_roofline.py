"""Roofline bound of the prefill attention the engine asked for (one
launch per layer per prefill call, counted from the calls' valid lengths
by frozen/counts.py) over the device time of the flash kernels, in the
profiled sub-window."""
NAME = "flash_roofline"
UNIT = "%"
LAYER = "kernel csrc/flash_attention.cu"


def read(record):
    p = record.get("profile")
    if not p or p["flash_dev_s"] <= 0 or p["flash_bound_s"] <= 0:
        return None
    return 100.0 * p["flash_bound_s"] / p["flash_dev_s"]
