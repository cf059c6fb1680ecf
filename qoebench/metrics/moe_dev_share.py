"""Device time of the kernels launched inside the MoE layer during decode
over the device time of the decode calls, from the profiled sub-window."""
NAME = "moe_dev_share"
UNIT = "ratio"
LAYER = "MoE layer (models/moe.py)"


def read(record):
    p = record.get("profile")
    if not p or p["moe_decode_dev_s"] <= 0 or p["decode_range_dev_s"] <= 0:
        return None
    return p["moe_decode_dev_s"] / p["decode_range_dev_s"]
