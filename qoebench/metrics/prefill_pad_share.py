"""Share of the prefill calls' token slots (padded rows x length bucket)
that hold padding, from the payloads of the window's
``engine.prefill_call`` spans."""
from qoebench.program_spans import calls

NAME = "prefill_pad_share"
UNIT = "ratio"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    got = calls(record)
    if got is None:
        return None
    found = got[0]
    slots = sum(c.payload["rows"] * c.payload["bucket"] for c in found)
    if slots <= 0:
        return None
    return 1.0 - sum(sum(c.payload["lengths"]) for c in found) / slots
