"""Mean over the window's engine steps of ``engine.kv.utilization``, the
share of the KV pool the scheduler's watermark reads."""
NAME = "kv_used_share"
UNIT = "ratio"
LAYER = "KV manager (serving/kv_manager.py)"


def read(record):
    xs = record.get("kv_util")
    if not xs:
        return None
    return sum(xs) / len(xs)
