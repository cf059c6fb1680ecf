"""Share of the window's prefill calls (``engine.prefill_call`` spans)
whose forward was replayed from a CUDA graph: their ``model.prefill``
child carries the payload ``{"graph": 1}``. Near 1 where every shape was
captured before the window; a program whose ``model.prefill`` carries no
such flag gives nothing to read."""
from qoebench.program_spans import calls

NAME = "prefill_graph_share"
UNIT = "ratio"
LAYER = "model step (models/model.py, models/transformer.py)"


def _flag(span):
    pay = span.payload
    return pay.get("graph") if isinstance(pay, dict) else None


def read(record):
    got = calls(record)
    if got is None:
        return None
    found, kids = got
    flags = [[_flag(k) for k in kids[c.seq] if k.name == "model.prefill"]
             for c in found]
    if not any(f is not None for fs in flags for f in fs):
        return None
    return sum(1 for fs in flags if 1 in fs) / len(found)
