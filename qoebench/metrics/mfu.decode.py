"""Model FLOPs of the decode calls (each active row's token through every
layer and the unembedding, attention over its context, for every step of
a block) over their synchronised host wall time, as a share of the
H100's bf16 peak."""
import numpy as np

from qoebench.frozen.counts import decode_flops
from qoebench.frozen.hardware import PEAK_BF16_FLOPS

NAME = "mfu.decode"
UNIT = "%"
LAYER = "model step (models/model.py, models/transformer.py)"


def read(record):
    calls = [c for c in record.get("decode_calls") or () if c["lengths"]]
    if not calls:
        return None
    wall = sum(c["wall"] for c in calls)
    flops = 0.0
    for c in calls:
        base = np.asarray(c["lengths"], dtype=np.int64)
        for s in range(c["j"]):
            flops += decode_flops(record["model"], base + s + 1)
    return 100.0 * flops / wall / PEAK_BF16_FLOPS
