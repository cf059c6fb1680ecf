"""Real rows (requests) a prefill call carries, from the payloads of the
window's ``engine.prefill_call`` spans."""
from qoebench.program_spans import calls

NAME = "prefill_rows_per_call"
UNIT = "rows"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    got = calls(record)
    if got is None:
        return None
    found = got[0]
    return sum(len(c.payload["lengths"]) for c in found) / len(found)
