"""Roofline bound of the paged decode attention the engine asked for (one
launch per layer per decode step over the active rows' attended lengths,
frozen/counts.py) over the device time of the decode kernels, in the
profiled sub-window."""
NAME = "decode_attn_roofline"
UNIT = "%"
LAYER = "kernel csrc/decode_attention.cu"


def read(record):
    p = record.get("profile")
    if not p or p["decode_dev_s"] <= 0 or p["decode_bound_s"] <= 0:
        return None
    return 100.0 * p["decode_bound_s"] / p["decode_dev_s"]
