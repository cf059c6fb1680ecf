"""Share of the prefill calls' seconds (``engine.prefill_call`` spans) in
which the host waits for the card to finish the call: each call's time
after its forward's enqueue (``model.prefill``) ends, less the host work
logged there (the slot write, ``prefill.write``; a clock sleep). In an
untraced run that is the first token's readback (``prefill.readback``)
and the argmax's launch; in a traced run the benchmark's sync after the
forward takes the wait over from the readback, and it is counted the
same. Near 0 when the host's launches, not the card, set a call's pace."""
from qoebench.program_spans import calls

NAME = "prefill_readback_share"
UNIT = "ratio"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    got = calls(record)
    if got is None:
        return None
    found, kids = got
    total = wait = 0.0
    for c in found:
        fwd = [k for k in kids[c.seq] if k.name == "model.prefill"]
        if not fwd:
            continue
        t = fwd[-1].end
        host = sum(k.end - k.start for k in kids[c.seq]
                   if k.start >= t and k.name != "prefill.readback")
        total += c.end - c.start
        wait += c.end - t - host
    return wait / total if total > 0 else None
