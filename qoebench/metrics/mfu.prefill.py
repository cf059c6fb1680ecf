"""Model FLOPs of the prefill calls (every valid token through every
layer, causal attention, the last position's unembedding) over their
synchronised host wall time, as a share of the H100's bf16 peak."""
from qoebench.frozen.counts import prefill_flops
from qoebench.frozen.hardware import PEAK_BF16_FLOPS

NAME = "mfu.prefill"
UNIT = "%"
LAYER = "model step (models/model.py, models/transformer.py)"


def read(record):
    calls = record.get("prefill_calls")
    if not calls:
        return None
    wall = sum(c["wall"] for c in calls)
    flops = sum(prefill_flops(record["model"], c["lengths"]) for c in calls)
    return 100.0 * flops / wall / PEAK_BF16_FLOPS
