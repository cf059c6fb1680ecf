"""Several windows in one process, for the measurements made once when a
cell is defined (the knee sweep, the correctness readings): the model,
weights and engine are built once and the weights redrawn in place per
seed."""
from __future__ import annotations

import time
from pathlib import Path

from qoebench import harness, registry, weights
from qoebench.frozen.workload import make_trace


class Session:
    def __init__(self, workload: str, seed: int, device: str = "cuda",
                 bench: dict = None, base: Path = registry.HERE,
                 traffic: str = None):
        import torch
        self.torch = torch
        self.device = device
        if bench is None:
            bench = registry.benchmark(base.parent)
        self.entry = registry.workload(bench, workload)
        self.cfgd = registry.config(self.entry["config"], base)
        self.mix = registry.traffic(traffic or self.entry["traffic"], base)
        self.check = registry.cell(workload, base)["check"]
        t = time.monotonic()
        self.model, self.params, self.engine = harness.build(
            self.cfgd, seed, device)
        self.seed = seed
        harness.warm_up(self.engine, self.cfgd, self.mix, seed)
        self.sync()
        harness.log(f"built and warmed in {time.monotonic() - t:.1f} s")

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def reseed(self, seed: int) -> None:
        if seed != self.seed:
            weights.reseed(self.params, seed,
                           self.cfgd.get("weights_std", 0.02))
            self.seed = seed
            self.sync()

    def window(self, seed: int, seconds: float, **mix_over) -> dict:
        """One lead-in and window at the cell's traffic, with `mix_over`
        replacing its parameters (rate, arrival, lead_in_s)."""
        self.reseed(seed)
        mix = dict(self.mix, **mix_over)
        trace = make_trace(mix, seed, seconds,
                           self.cfgd["model"]["vocab_size"])
        self.engine.observer = None
        rec = harness.drive(self.engine, trace, mix, seconds,
                            time.monotonic())
        self.sync()
        return rec
