"""95th percentile, over the requests due in the window and admitted
before its profiled seconds, of the start of the ``engine.prefill_call``
span that carries the request's rid less its admission stamp: how long
an admitted request waits, inside the engine's steps, for its own
prefill call. A request whose call has not started by the profiled
seconds' start counts until then."""
from qoebench.frozen.endtoend import due_in_window, percentile
from qoebench.program_spans import calls, profiled_start

NAME = "prefill_wait_p95_s"
UNIT = "s"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    got = calls(record)
    if got is None:
        return None
    p0 = profiled_start(record)
    start = {}
    for c in got[0]:
        for rid in c.payload["rids"]:
            start.setdefault(rid, c.start)
    waits = []
    for r in due_in_window(record):
        a = r["admit"]
        if a is None or not record["window"][0] <= a < p0:
            continue
        waits.append(max(start.get(r["rid"], p0), a) - a)
    if not waits:
        return None
    return percentile(waits, 95)
