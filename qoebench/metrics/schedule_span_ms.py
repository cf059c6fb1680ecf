"""Host ms the engine's ``engine.schedule`` span takes per
``engine.step`` span, from the port's own span log (the twin of
``sched_ms_per_step``, which times the scheduler from outside). In the
traced run, where it is read, the span also holds the benchmark's
wrapper of ``schedule()`` (a profiler range, a clock read and an
append), which its twin times from inside."""
from qoebench.program_spans import wall, window

NAME = "schedule_span_ms"
UNIT = "ms"
LAYER = "scheduler (core/policies/andes.py)"


def read(record):
    spans = window(record)
    if not spans:
        return None
    steps = {s.seq for s in spans if s.name == "engine.step"}
    if not steps:
        return None
    return 1e3 * wall(s for s in spans if s.name == "engine.schedule"
                      and s.parent in steps) / len(steps)
