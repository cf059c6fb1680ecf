"""Share of the profiled sub-window in which no kernel ran on the card."""
NAME = "device_idle"
UNIT = "ratio"
LAYER = "device (H100)"


def read(record):
    p = record.get("profile")
    if not p or p["window_s"] <= 0 or p["kernels"] <= 0:
        return None
    return max(0.0, 1.0 - p["busy_s"] / p["window_s"])
