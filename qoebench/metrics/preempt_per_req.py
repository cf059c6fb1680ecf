"""Preemptions in the window over the requests admitted in it."""
NAME = "preempt_per_req"
UNIT = "1/req"
LAYER = "scheduler and KV manager (core/policies/andes.py, serving/kv_manager.py)"


def read(record):
    if not record.get("admitted"):
        return None
    return record["preemptions"] / record["admitted"]
