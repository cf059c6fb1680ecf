"""Routed expert slots (live tokens x top-k) over the expert rows the
expert products computed (experts x capacity), over the moe decode steps
since the engine's last reset (lead-in and window): the counters
``moe.routed_slots`` and ``moe.expert_rows`` of the newest span log. A
program without them gives nothing to read."""
NAME = "moe_slot_use"
UNIT = "ratio"
LAYER = "MoE layer (models/moe.py)"


def read(record):
    try:
        from repro_torch.obs.spans import logs
    except ImportError:
        return None
    held = logs()
    if not held:
        return None
    c = held[-1].counters
    rows = c.get("moe.expert_rows", 0)
    if rows <= 0 or "moe.routed_slots" not in c:
        return None
    return c["moe.routed_slots"] / rows
