"""Model FLOPs of the prefill calls (frozen/counts.py over each call's
valid lengths, from its ``engine.prefill_call`` span's payload) over the
calls' spans, each of which ends once the host holds its first token, as
a share of the H100's bf16 peak (the twin of ``mfu.prefill``, whose
walls leave out staging, cache set-up, the write and the readback). In
the traced run, where it is read, the calls also hold the benchmark's
syncs before and after the forward: the first waits for the cache's
set-up, the second takes over the readback's wait for the card."""
from qoebench.frozen.counts import prefill_flops
from qoebench.frozen.hardware import PEAK_BF16_FLOPS
from qoebench.program_spans import calls, wall

NAME = "mfu.prefill_call"
UNIT = "%"
LAYER = "model step (models/model.py, models/transformer.py)"


def read(record):
    got = calls(record)
    if got is None:
        return None
    found = got[0]
    seconds = wall(found)
    if seconds <= 0:
        return None
    flops = sum(prefill_flops(record["model"], c.payload["lengths"])
                for c in found)
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
