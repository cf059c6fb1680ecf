"""The knee sweep of a cell's traffic, on the chip, once, when the cell
is defined:

    python -m qoebench.sweep --workload <cell> --rates 6,9,12 \
        --seconds 20 [--arrival poisson] [--lead-in 20]

For each rate, one lead-in and window in one process, and a line with the
share of the requests due in the window (less its last 5 s) that met both
their TTFT and their TDS, the backlog (due, not yet given a first token)
at the window's start and end, TTFT and QoE, tokens/s, the KV pool's
peak use and preemptions, and the mean lifetime of finished requests. The
knee is the highest rate with at least 90% met and no backlog growing
across the window. ``--rates closed`` runs a closed-loop mix once
instead. The run ends with the pool rule's inputs: the card's memory,
the weights, the pool the configuration gave, and the peak the warm-up
and the windows reached beyond them (the step peak)."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from qoebench import harness, weights
from qoebench.frozen import endtoend
from qoebench.frozen.counts import kv_token_bytes
from qoebench.frozen.pool import pool_tokens


def met(record: dict, tail: float = 5.0) -> float:
    w0, w1 = record["window"]
    ok, n = 0, 0
    for r in record["requests"]:
        if not (w0 <= r["due"] < w1 - tail):
            continue
        n += 1
        t = endtoend.token_times(r, w1)
        if not t or t[0] - r["due"] > r["ttft"]:
            continue
        if len(t) >= 2 and (len(t) - 1) / max(t[-1] - t[0], 1e-9) < r["tds"]:
            continue
        ok += 1
    return ok / max(n, 1)


def backlog(record: dict, at: float) -> int:
    """Requests due by `at` that had no first token by then."""
    return sum(1 for r in record["requests"] if r["due"] <= at
               and not any(t <= at for t, _k in r["emits"]))


def lifetime(record: dict) -> float:
    xs = [r["finish"] - r["due"] for r in record["requests"]
          if r["finish"] is not None]
    return float(np.mean(xs)) if xs else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--lead-in", type=float, default=None)
    ap.add_argument("--arrival", default=None)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from qoebench.session import Session
    s = Session(args.workload, args.seed)
    torch = s.torch
    eng = s.engine
    wbytes = weights.param_bytes(s.params)
    pool_bytes = sum(eng.cache[k].numel() * eng.cache[k].element_size()
                     for k in ("k", "v"))
    total = torch.cuda.get_device_properties(0).total_memory
    peak = torch.cuda.max_memory_allocated()
    kvb = kv_token_bytes(s.cfgd["model"])

    def pool_line(peak):
        step_peak = peak - wbytes - pool_bytes
        harness.log(
            f"pool rule: total {total} B, weights {wbytes} B, pool "
            f"{pool_bytes} B, peak {peak} B, step peak {step_peak} B, KV "
            f"{kvb} B/token -> pool_tokens "
            f"{pool_tokens(total, wbytes, step_peak, kvb, eng._page_size)}")

    pool_line(peak)
    over = {}
    if args.arrival:
        over["arrival"] = args.arrival
    if args.lead_in is not None:
        over["lead_in_s"] = args.lead_in
    rows = []
    top = peak
    closed = args.rates == "closed"
    for i, rate in enumerate([0.0] if closed else
                             [float(x) for x in args.rates.split(",")]):
        torch.cuda.reset_peak_memory_stats()
        if not closed:
            over["rate"] = rate
        rec = s.window(args.seed + i, args.seconds, **over)
        top = max(top, torch.cuda.max_memory_allocated())
        w0, w1 = rec["window"]
        row = dict(
            rate=rate, met=met(rec), backlog_start=backlog(rec, w0),
            backlog_end=backlog(rec, w1),
            ttft_p50=endtoend.percentile(endtoend.ttfts(rec), 50),
            ttft_p95=endtoend.ttft_p95_s(rec), qoe=endtoend.qoe_mean(rec),
            tokens_per_s=endtoend.tokens_per_s(rec),
            peak_kv=rec["peak_kv_util"], preemptions=rec["preemptions"],
            admitted=rec["admitted"], iterations=rec["iterations"],
            steps=rec["steps"], lifetime_s=lifetime(rec),
            tick_sleep_s=rec["tick_sleep_s"],
            mem_peak=int(torch.cuda.max_memory_allocated()))
        rows.append(row)
        print(json.dumps(row), flush=True)
    pool_line(top)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
