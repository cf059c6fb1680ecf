"""The traced run's instrumentation, all in the benchmark's own files.

Host ranges (``torch.profiler.record_function``) wrap, on the instances,
the engine's step, the scheduler's ``schedule``, the model's ``prefill``,
the engine's decode entry points and its ``_tick``, and the port's MoE
layer (by phase: ``qoebench.moe.prefill`` / ``qoebench.moe.decode``). The
prefill and decode wrappers synchronise the card before and after each
call, to time it on the host and to read the lengths it attends: those
syncs exist only in a traced run. ``torch.profiler`` covers a few seconds
in the middle of the window; the host ranges and counters cover all of
it, leaving out the profiled seconds, whose host times the profiler
inflates. The profiled seconds are the window's last: the profiler
parses its events when it stops, which takes seconds, so it stops after
the window has closed. Its first start, which loads CUPTI, is made
during set-up (``warm``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from qoebench.frozen import counts

LABELS = (("qoebench.schedule", "schedule"), ("qoebench.prefill", "prefill"),
          ("qoebench.decode", "decode"), ("qoebench.tick", "tick_sleep"),
          ("qoebench.step", "emit_and_bookkeeping"))
FLASH = ("flash_mma_kernel", "flash_kernel")
DECODE = ("decode_kernel",)


class Tracer:
    def __init__(self, model, cfgd: dict, lead: float, seconds: float,
                 device: str, profile_s: float = 3.0):
        import torch
        self.torch = torch
        self.model = model
        self.cfgd = cfgd
        self.cuda = device == "cuda"
        span = min(profile_s, seconds / 3.0)
        self.p0 = lead + seconds - span
        self.window = (lead, lead + seconds)
        self.prof = None
        self.profiled = None            # engine-clock span profiled
        self.host_span = None
        self.sched: List[tuple] = []
        self.steps: List[float] = []
        self.prefills: List[dict] = []
        self.decodes: List[dict] = []
        self.phase = "other"

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    # ---------------------------------------------------------- wrappers
    def install(self, engine) -> None:
        rf = self.torch.profiler.record_function
        clock = engine.wall_now
        tracer = self

        sched = engine.sched.schedule

        def schedule(now, live, fluid):
            with rf("qoebench.schedule"):
                t = time.perf_counter()
                out = sched(now, live, fluid)
                tracer.sched.append((clock(), time.perf_counter() - t))
            return out

        engine.sched.schedule = schedule

        prefill = self.model.prefill

        def prefill_fn(params, batch, cache):
            toks = batch["tokens"]
            lens = batch.get("lengths")
            lengths = ([int(x) for x in lens.tolist() if x > 0]
                       if lens is not None else [toks.shape[1]] * toks.shape[0])
            tracer._sync()
            t = time.perf_counter()
            tracer.phase = "prefill"
            with rf("qoebench.prefill"):
                out = prefill(params, batch, cache)
                tracer._sync()
            tracer.phase = "other"
            tracer.prefills.append(dict(t=clock(), wall=time.perf_counter() - t,
                                        lengths=lengths))
            return out

        self.model.prefill = prefill_fn

        def wrap_decode(name, steps_of):
            inner = getattr(engine, name)

            def fn(*a, **kw):
                lengths = a[2]["length"].cpu().numpy()
                tracer._sync()
                t = time.perf_counter()
                tracer.phase = "decode"
                with rf("qoebench.decode"):
                    out = inner(*a, **kw)
                    tracer._sync()
                tracer.phase = "other"
                tracer.decodes.append(dict(
                    t=clock(), wall=time.perf_counter() - t,
                    j=int(steps_of(a)),
                    lengths=[int(x) for x in lengths if x > 0]))
                return out

            setattr(engine, name, fn)

        wrap_decode("_decode_persist", lambda a: a[3])
        wrap_decode("_decode_multi", lambda a: a[3])
        wrap_decode("_decode_tok", lambda a: 1)
        wrap_decode("_decode", lambda a: 1)

        tick = engine._tick

        def tick_fn(seconds):
            with rf("qoebench.tick"):
                return tick(seconds)

        engine._tick = tick_fn

        from repro_torch.models import moe as moe_mod
        moe_apply = moe_mod.moe_apply

        def moe_fn(*a, **kw):
            with rf(f"qoebench.moe.{tracer.phase}"):
                return moe_apply(*a, **kw)

        moe_mod.moe_apply = moe_fn
        self._restore = (moe_mod, moe_apply)

    def uninstall(self) -> None:
        """Put the port's MoE entry and the model's prefill back, so no
        wrapper keeps the engine alive past the window."""
        moe_mod, moe_apply = self._restore
        moe_mod.moe_apply = moe_apply
        self.model.__dict__.pop("prefill", None)

    def step(self, engine) -> bool:
        self.steps.append(engine.wall_now())
        with self.torch.profiler.record_function("qoebench.step"):
            return engine.step()

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Load the profiler's machinery (CUPTI) once, during set-up."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            x = self.torch.ones(8, device="cuda" if self.cuda else "cpu")
            (x + 1).sum().item()

    def tick(self, now: float) -> None:
        """Start the profiler at the profiled seconds' start (between
        engine steps)."""
        from torch.profiler import profile
        if self.prof is None and self.profiled is None and now >= self.p0:
            self._sync()
            self.prof = profile(activities=self._activities())
            self.prof.start()
            self._start = (now, time.perf_counter())

    def close(self, now: float) -> None:
        """Stop the profiler once the window has closed."""
        if self.prof is None:
            return
        self._sync()
        self.host_span = time.perf_counter() - self._start[1]
        self.profiled = (self._start[0], now)
        self.prof.stop()
        self._prof_done, self.prof = self.prof, None

    # --------------------------------------------------------- reduction
    def _outside(self, t: float) -> bool:
        w0, w1 = self.window
        if not (w0 <= t < w1):
            return False
        if self.profiled is not None:
            return not (self.profiled[0] <= t <= self.profiled[1])
        return True

    def _inside(self, t: float) -> bool:
        return (self.profiled is not None
                and self.profiled[0] <= t <= self.profiled[1])

    def record(self) -> dict:
        """The traced run's part of the record (see metrics/)."""
        self.uninstall()
        model = self.cfgd["model"]
        out: Dict = {}
        out["sched_s"] = float(sum(s for t, s in self.sched
                                   if self._outside(t)))
        out["sched_steps"] = sum(1 for t in self.steps if self._outside(t))
        out["prefill_calls"] = [p for p in self.prefills
                                if self._outside(p["t"])]
        out["decode_calls"] = [d for d in self.decodes
                               if self._outside(d["t"])]
        out["model"] = model
        prof = getattr(self, "_prof_done", None)
        if prof is None:
            return out
        out["profile"] = self._reduce(prof, model)
        return out

    def _reduce(self, prof, model: dict) -> dict:
        from torch.autograd import DeviceType
        L = model["num_layers"]
        page = self.cfgd["serving"]["page_size"]
        evs = prof.events()
        # the device timeline also carries each host range's span
        # (``gpu_user_annotation``), named as the range: not a kernel
        kern = [e for e in evs if e.device_type == DeviceType.CUDA
                and not e.name.startswith("qoebench.")]
        hosts = [e for e in evs if e.device_type == DeviceType.CPU
                 and e.name.startswith("qoebench.")]
        by_name: Dict[str, float] = {}
        iv = []
        for e in kern:
            s, t = e.time_range.start, e.time_range.end
            iv.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
        iv.sort()
        merged = []
        for s, t in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) / 1e6
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)
                if merged[i + 1][0] > merged[i][1]]
        ranges = {lab: sorted((e.time_range.start, e.time_range.end)
                              for e in hosts if e.name == name)
                  for name, lab in LABELS}
        label_of = _label_gaps(gaps, ranges)
        idle: Dict[str, float] = {}
        for (g0, g1), lab in zip(gaps, label_of):
            idle[lab] = idle.get(lab, 0.0) + (g1 - g0) / 1e6
        longest = sorted(zip(gaps, label_of), key=lambda x: x[0][0] - x[0][1])
        idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:6]
        idle_gaps += [(f"longest:{lab}", (g1 - g0) / 1e6)
                      for (g0, g1), lab in longest[: 10 - len(idle_gaps)]]
        flash_dev = sum(v for k, v in by_name.items()
                        if any(f in k for f in FLASH))
        dec_dev = sum(v for k, v in by_name.items()
                      if any(f in k for f in DECODE))
        flash_bound = sum(L * counts.flash_bound_s(model, p["lengths"])
                          for p in self.prefills if self._inside(p["t"]))
        dec_bound = 0.0
        for d in self.decodes:
            if not self._inside(d["t"]) or not d["lengths"]:
                continue
            base = np.asarray(d["lengths"], dtype=np.int64)
            for s in range(d["j"]):
                dec_bound += L * counts.decode_bound_s(model, base + s + 1,
                                                       page)
        ka = {e.key: e for e in prof.key_averages()}

        def dev_total(key):
            e = ka.get(key)
            if e is None:
                return 0.0
            v = getattr(e, "device_time_total", None)
            if v is None:
                v = getattr(e, "cuda_time_total", 0.0)
            return float(v) / 1e6

        top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        return dict(
            busy_s=busy, window_s=float(self.host_span),
            kernels=len(kern), device_ops=[[k[:120], v] for k, v in top],
            idle_gaps=[[k, v] for k, v in idle_gaps],
            flash_dev_s=flash_dev, flash_bound_s=flash_bound,
            decode_dev_s=dec_dev, decode_bound_s=dec_bound,
            moe_decode_dev_s=dev_total("qoebench.moe.decode"),
            decode_range_dev_s=dev_total("qoebench.decode"))


def _label_gaps(gaps, ranges) -> List[str]:
    """What the host was doing at each gap's midpoint: the first of
    LABELS' ranges that covers it, else ``between_steps``."""
    mids = np.array([(a + b) / 2.0 for a, b in gaps], dtype=np.float64)
    out = np.array(["between_steps"] * len(gaps), dtype=object)
    done = np.zeros(len(gaps), dtype=bool)
    for _name, lab in LABELS:
        rs = ranges.get(lab) or []
        if not rs or not len(mids):
            continue
        starts = np.array([s for s, _ in rs], dtype=np.float64)
        ends = np.array([e for _, e in rs], dtype=np.float64)
        idx = np.searchsorted(starts, mids, side="right") - 1
        ok = (idx >= 0) & (mids < ends[np.clip(idx, 0, None)]) & ~done
        out[ok] = lab
        done |= ok
    return list(out)
