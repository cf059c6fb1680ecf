"""One run of one cell: set-up, lead-in and window (harness.drive), the
end-to-end or per-layer metrics, the device's numbers, and the check of
the served tokens against the plain reference."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Tuple

from qoebench import harness, registry
from qoebench.frozen import endtoend
from qoebench.frozen.workload import make_trace


def run_cell(bench: dict, entry: dict, seed: int, seconds: float,
             traced: bool, *, device: str, t_start: float,
             base: Path = registry.HERE) -> Tuple[dict, dict]:
    """Returns (result line, record)."""
    import torch
    cfgd = registry.config(entry["config"], base)
    mix = registry.traffic(entry["traffic"], base)
    check = registry.cell(entry["name"], base)["check"]
    cuda = device == "cuda"

    model, params, engine = harness.build(cfgd, seed, device)
    harness.warm_up(engine, cfgd, mix, seed)
    if cuda:
        torch.cuda.synchronize()
    trace = make_trace(mix, seed, seconds, cfgd["model"]["vocab_size"])
    tracer = None
    if traced:
        from qoebench.trace import Tracer
        tracer = Tracer(model, cfgd, float(mix["lead_in_s"]), seconds,
                        device)
        tracer.warm()
    record = harness.drive(engine, trace, mix, seconds, t_start, tracer)
    if cuda:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    record["model"] = cfgd["model"]
    record["memory_peak_bytes"] = peak
    if tracer is not None:
        record.update(tracer.record())
    harness.log(
        f"{entry['name']} seed {seed}: setup {record['setup_s']:.3f} s "
        f"(lead-in {record['lead_in_s']} s), window {seconds} s, "
        f"slept in _tick {record['tick_sleep_s']:.4f} s in the window and "
        f"{record['tick_sleep_lead_s']:.4f} s in the lead-in, "
        f"{record['steps']} steps, {record['iterations']} decode iterations,"
        f" {record['preemptions']} preemptions, peak KV use "
        f"{record['peak_kv_util']:.4f}, memory peak {peak}")

    window = endtoend.due_in_window(record)
    attempted = len(window)
    failed = len({r["rid"] for r in window} & set(record["failed"]))
    if traced:
        metrics = registry.read_metrics(
            registry.per_layer_for(bench, entry["name"]), record, base)
    else:
        metrics = {}
        for m in registry.end_to_end_for(bench, entry["name"]):
            if m["name"] == "setup_s":
                value = record["setup_s"]
            else:
                value = endtoend.END_TO_END[m["name"]](record)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    sample = harness.sample_served(record, check, seed)
    # the program's state goes before the reference runs: only the weights,
    # which the benchmark made, stay on the card
    del engine, model, tracer
    harness.free_device_memory()
    t = time.monotonic()
    res = harness.check_served(cfgd, params, sample, device) if sample \
        else {"widest_gap": None, "tokens": 0, "requests": 0,
              "preempted": 0}
    harness.log(f"check over {res['requests']} requests ({res['preempted']} "
                f"preempted and resumed), {res['tokens']} served tokens, in "
                f"{time.monotonic() - t:.2f} s")
    limit = float(check["widest_gap_limit"])
    correct = bool(res["requests"] > 0 and res["widest_gap"] <= limit)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    prof = record.get("profile")
    if traced and prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {"widest_gap": {"value": res["widest_gap"],
                                       "limit": limit}}
    record.pop("_served", None)
    record["check"] = res
    return result, record
