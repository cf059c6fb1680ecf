"""Share of the prefill calls' seconds (``engine.prefill_call`` spans)
spent enqueueing the model's forward (their ``model.prefill`` children):
near 1 when the host's launches set a call's pace."""
from qoebench.program_spans import part_share

NAME = "prefill_forward_share"
UNIT = "ratio"
LAYER = "model step (models/model.py, models/transformer.py)"


def read(record):
    return part_share(record, "model.prefill")
