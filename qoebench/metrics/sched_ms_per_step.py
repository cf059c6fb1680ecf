"""Host time the scheduler's ``schedule`` takes per engine step (the
harness times it on the instance in the traced run)."""
NAME = "sched_ms_per_step"
UNIT = "ms"
LAYER = "scheduler (core/policies/andes.py)"


def read(record):
    steps = record.get("sched_steps")
    if not steps:
        return None
    return record["sched_s"] / steps * 1e3
