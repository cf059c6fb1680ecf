"""95th percentile over the requests due in the window of the admission
stamp less the due time (the window's end for one not admitted by then):
how far a running decode block carries past a due arrival."""
from qoebench.frozen.endtoend import due_in_window, percentile

NAME = "admit_lag_p95_s"
UNIT = "s"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    w1 = record["window"][1]
    lags = [(r["admit"] if r["admit"] is not None and r["admit"] < w1
             else w1) - r["due"] for r in due_in_window(record)]
    if not lags:
        return None
    return percentile(lags, 95)
