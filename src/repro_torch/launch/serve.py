"""Serving launcher: the real engine, or the simulator at paper-scale
deployments — ``src/repro/launch/serve.py`` with ``--device`` (default
``cuda``; ``cpu`` runs the plain versions) and ``--dataset``.

  python -m repro_torch.launch.serve --mode engine --arch llama3-8b \\
      --requests 20                      # full width, f32, on the card
  python -m repro_torch.launch.serve --mode engine --arch llama3-8b \\
      --smoke --requests 8 --device cpu
  python -m repro_torch.launch.serve --mode sim --rate 3.6 --requests 1000

``--mode sim`` is host code: the discrete-event ``ServingSimulator`` on
the ``A100_4X`` latency model over a ``make_workload`` trace. ``--mode
engine`` serves random f32 weights drawn from `--seed` through the
``ServingEngine`` on the ``TPU_V5E`` virtual clock, with the reference's
numpy request draws, so its line (finished, tokens, preemptions, QoE)
depends only on lengths and batch composition and equals the reference's.

``--dataset`` (``sharegpt`` or ``multiround``) is passed to
``make_workload``. The reference's ``run_sim`` reads ``args.dataset``,
but its parser defines no such flag, so its ``--mode sim`` raises
``AttributeError``; the port's flag defaults to ``make_workload``'s own
default.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (A100_4X, TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.simulator import ServingSimulator, SimConfig
from repro_torch.workload import make_workload


def run_sim(args) -> None:
    cfg = get_config(args.arch)
    lat = LatencyModel(cfg, A100_4X)
    wl = make_workload(args.requests, args.rate, seed=args.seed,
                       dataset=args.dataset)
    sched = make_scheduler(args.scheduler, args.kv_capacity, lat,
                           SchedulerConfig(objective=args.objective))
    res = ServingSimulator(sched, lat,
                           SimConfig(kv_capacity_tokens=args.kv_capacity)).run(wl)
    q = res.qoes()
    print(f"scheduler={args.scheduler} rate={args.rate} n={args.requests}")
    print(f"  avg QoE        {res.avg_qoe():.3f}  (p10 {np.percentile(q,10):.2f}"
          f" p50 {np.percentile(q,50):.2f})")
    print(f"  TTFT p50/p90   {np.percentile(res.ttfts(),50):.2f}s /"
          f" {np.percentile(res.ttfts(),90):.2f}s")
    print(f"  throughput     {res.throughput():.1f} tok/s")
    print(f"  preemptions    {res.preemption_freq():.2f} /request")


def run_engine(args) -> None:
    from repro_torch.models import Model

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    lat = LatencyModel(cfg, TPU_V5E)
    rng = np.random.default_rng(args.seed)
    wl = []
    for i in range(args.requests):
        plen = int(rng.integers(8, 32))
        wl.append(Request(
            rid=i, arrival=i * 1.0 / args.rate, prompt_len=plen,
            output_len=int(rng.integers(8, 24)),
            spec=QoESpec(ttft=1.0, tds=4.8),
            prompt_tokens=rng.integers(0, cfg.vocab_size, plen),
        ))
    sched = make_scheduler(args.scheduler, args.kv_capacity, lat,
                           SchedulerConfig(objective=args.objective))
    eng = ServingEngine(model, params, sched, lat, num_slots=args.slots,
                        max_seq=args.max_seq,
                        capacity_tokens=args.kv_capacity,
                        device=model.device)
    out = eng.run(wl)
    done = [r for r in out if r.generated >= r.output_len]
    print(f"engine: {len(done)}/{len(wl)} finished, "
          f"{eng.total_tokens} tokens, {eng.preemptions} preemptions, "
          f"avg QoE {np.mean([r.final_qoe() for r in done]):.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", choices=("sim", "engine"), default="sim")
    ap.add_argument("--arch", default="opt-66b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheduler", default="andes",
                    choices=("fcfs", "round_robin", "andes", "andes_dp"))
    ap.add_argument("--objective", default="avg_qoe")
    ap.add_argument("--rate", type=float, default=3.3)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--kv-capacity", type=int, default=65_000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="sharegpt",
                    choices=("sharegpt", "multiround"),
                    help="--mode sim's length distribution")
    ap.add_argument("--device", default="cuda",
                    help="--mode engine's torch device (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.mode == "sim":
        run_sim(args)
    else:
        if not args.smoke:
            print("note: full configs on CPU are slow; use --smoke")
        args.kv_capacity = min(args.kv_capacity, args.slots * args.max_seq)
        run_engine(args)


if __name__ == "__main__":
    main()
