"""Baseline policies: FCFS (vLLM default) and Round-Robin (paper §6.1)."""
from __future__ import annotations

from typing import List

from repro_torch.core.policies.base import Scheduler
from repro_torch.core.request import Request, ReqState


class FCFSScheduler(Scheduler):
    """vLLM-style: running requests keep running; waiting requests admitted
    in arrival order while KV memory allows; preemption only on OOM
    (most-recent-arrival victim first)."""

    name = "fcfs"

    def schedule(self, now, live, fluid):
        self.iteration += 1
        running = [r for r in live if r.state == ReqState.RUNNING]
        queued = sorted(
            (r for r in live if r.state in (ReqState.WAITING, ReqState.SWAPPED)),
            key=lambda r: r.arrival,
        )
        st = self.cfg.state_equiv_tokens
        # OOM handling: victimize most recent arrivals (vLLM recompute policy)
        running.sort(key=lambda r: r.arrival)
        used = 0
        keep: List[Request] = []
        for r in running:
            w = r.kv_tokens(st)
            if used + w <= self.M:
                keep.append(r)
                used += w
        # admit in arrival order (reserve the full prompt)
        for r in queued:
            w = r.kv_tokens(st)
            if used + w <= self.M:
                keep.append(r)
                used += w
            else:
                break
        self._record_decision(now, live, keep,
                              {"kv_used": int(used)}
                              if self.obs is not None else None)
        return keep


class RoundRobinScheduler(Scheduler):
    """Fair-share baseline (paper §6.1): every `interval` iterations the
    running set is rotated to the back of a cyclic queue."""

    name = "round_robin"

    def __init__(self, kv_capacity, lat, cfg=None, interval: int = 50):
        super().__init__(kv_capacity, lat, cfg)
        self.interval = interval
        self._order: List[int] = []      # rids, cyclic service order

    def reset(self):
        super().reset()
        self._order = []

    def schedule(self, now, live, fluid):
        self.iteration += 1
        by_rid = {r.rid: r for r in live}
        # maintain cyclic order: append newcomers, drop finished
        known = set(self._order)
        for r in sorted(live, key=lambda q: q.arrival):
            if r.rid not in known:
                self._order.append(r.rid)
        self._order = [rid for rid in self._order if rid in by_rid]

        rotate = self.iteration % self.interval == 0
        if rotate:
            running_rids = [rid for rid in self._order
                            if by_rid[rid].state == ReqState.RUNNING]
            self._order = [rid for rid in self._order
                           if rid not in running_rids] + running_rids

        st = self.cfg.state_equiv_tokens
        used = 0
        keep: List[Request] = []
        for rid in self._order:
            r = by_rid[rid]
            w = r.kv_tokens(st)
            if used + w <= self.M:
                keep.append(r)
                used += w
        self._record_decision(now, live, keep,
                              {"rotated": bool(rotate), "kv_used": int(used)}
                              if self.obs is not None else None)
        return keep
