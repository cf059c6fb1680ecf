"""Rows that hold a request over the rows the decode computes, from the
payloads of the window's ``engine.decode_block`` spans (``rows``: the
live rows; ``slots``: the batch width the decode ran at), each block
weighted by its steps ``j``. A program whose spans carry no ``slots``
gives nothing to read."""
from qoebench.program_spans import window

NAME = "decode_live_share"
UNIT = "ratio"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    spans = window(record)
    if not spans:
        return None
    blocks = [s.payload for s in spans if s.name == "engine.decode_block"
              and s.payload and "slots" in s.payload]
    slots = sum(p["j"] * p["slots"] for p in blocks)
    if slots <= 0:
        return None
    return sum(p["j"] * p["rows"] for p in blocks) / slots
