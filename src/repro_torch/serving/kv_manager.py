"""KV manager: paged/block cache accounting + swap/recompute store.

The TPU adaptation of vLLM's paged KV (DESIGN.md §3): the device cache is a
fixed (L, B_slots, S_max, ...) pytree; this manager owns

  * slot allocation (request -> batch slot),
  * token-granular accounting (the scheduler's knapsack weights / capacity M),
  * page-granular allocation (``page_size``): capacity is a pool of
    fixed-size pages, each resident holds a **block table** (an ordered
    list of page ids covering its committed context), and admission /
    ``grow`` / release move whole pages between the pool and the tables,
  * the request metadata store: swapped-out KV/state lives here as host
    numpy arrays (paper Fig. 6 step 3) until swap-in or recompute.

Page/block-table layout
-----------------------
Pages are an *accounting* granularity, not a device layout: each request
still owns one contiguous cache row (attention masks by ``length``, so a
row is always a valid prefix), and a page id is a handle into the
capacity pool. ``block_table[rid]`` maps a resident's context onto
``ceil(held_tokens / page_size)`` page ids; the last page may be
partially filled, and eviction (release / swap_out / drop / evict_tail)
returns partial pages to the pool with the full ones — that is what
makes preemption and admission finer-grained than whole ``max_seq``
slots. Two degenerate cases pin the paging against the unpaged
differential suites:

  * ``page_size=None`` or ``page_size >= max_seq`` — the legacy
    fixed-depth slot manager, bit-for-bit (a request can never span two
    pages, so the page pool is exactly the slot pool);
  * ``page_size=1`` — one page per token: the page-pool check is
    arithmetically identical to the token-capacity check, so a paged
    engine reproduces the legacy engine bit-for-bit
    (tests/test_paged_kv.py runs the engine differential both ways).

Speculative engines keep a *second* device cache (the draft model's, same
slot layout — serving/speculative.py); its parked slices ride alongside the
target's in `draft_store`, keyed by the same rid, so a preempted request's
two caches round-trip host RAM together and release together. Accounting
stays in target-KV tokens (that is the scheduler's capacity M); the draft's
proportional cost enters through SpeculativeLatencyModel's swap/prefill
pricing instead.

``burst_reserve`` is the admission headroom for speculative growth: one
verify step can grow a request by up to k+1 tokens before the scheduler
next runs — and EVERY resident can, simultaneously. ``can_allocate``
therefore charges the reserve once per already-resident request plus once
for the candidate (charging it once per *admission* under-reserves by
``burst_reserve * residents`` tokens and a synchronized verify burst can
overfill capacity — tests/test_kv_accounting.py holds the regression).
"""
from __future__ import annotations

from typing import Dict, List, Optional


from repro_torch.core.request import Request


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _slice_bytes(host_slice: Optional[dict]) -> int:
    """Bytes of a parked slice (host tensors or numpy arrays)."""
    if host_slice is None:
        return 0
    return sum(int(v.nbytes) for v in _leaves(host_slice))


class KVSlotManager:
    def __init__(self, num_slots: int, max_seq: int,
                 capacity_tokens: Optional[int] = None,
                 burst_reserve: int = 0,
                 page_size: Optional[int] = None):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.capacity_tokens = capacity_tokens or num_slots * max_seq
        self.burst_reserve = burst_reserve
        # page_size >= max_seq collapses to the legacy slot manager: one
        # page per request IS a slot, and the free-slot check subsumes the
        # pool check. Kept as the explicit degenerate case so every
        # pre-paging differential suite pins this refactor.
        self.page_size = page_size
        self.paged = page_size is not None and 0 < page_size < max_seq
        if self.paged:
            self.total_pages = -(-self.capacity_tokens // page_size)
        else:
            self.total_pages = num_slots
        self.reset()

    def reset(self) -> None:
        """Clear all occupancy state in place (including the peak
        high-water mark and swap accounting, which a fresh run must not
        inherit). In-place so external references — observability gauges
        bound to an engine's `kv` — stay valid across `engine.reset()`."""
        # monotone edition counter of the page/slot assignment: bumped on
        # every page movement (take/free) and on reset, so a physically
        # paged engine can cheaply detect "tables moved, re-upload the
        # device block tables" without diffing them
        self.version = getattr(self, "version", 0) + 1
        self.free_slots: List[int] = list(range(self.num_slots))
        self.slot_of: Dict[int, int] = {}          # rid -> slot
        self.tokens_used = 0
        self.peak_tokens_used = 0                  # high-water mark
        self.held_tokens: Dict[int, int] = {}      # rid -> tokens charged
        self.host_store: Dict[int, dict] = {}      # rid -> host pytree slice
        self.draft_store: Dict[int, dict] = {}     # rid -> parked draft slice
        # page pool (paged mode): LIFO free list + per-request block tables
        self.block_table: Dict[int, List[int]] = {}
        self.free_pages: List[int] = (
            list(range(self.total_pages - 1, -1, -1)) if self.paged else [])
        self.pages_used = 0
        self.peak_pages_used = 0
        # overdraft pages (ids >= total_pages) are ledger fictions — they
        # name no row of a physical pool, so the physical_* reporting
        # surface excludes them (pages_used keeps counting them: that is
        # the visible overdraft signal)
        self.overdraft_pages = 0
        # preemption accounting: swap_out moves bytes (DMA priced by the
        # LatencyModel); drop discards — both are visible, per mode
        self.swap_bytes_total = 0
        self.swaps_out_total = 0
        self.drops_total = 0
        self.dropped_bytes_total = 0     # parked host bytes discarded by drop

    @property
    def slots_in_use(self) -> int:
        """Batch slots currently holding a resident request."""
        return self.num_slots - len(self.free_slots)

    def pages_for(self, tokens: int) -> int:
        """Pages covering `tokens` (0 in unpaged mode: the slot is the
        page and the free-slot check already charges it)."""
        if not self.paged or tokens <= 0:
            return 0
        return -(-tokens // self.page_size)

    def occupancy(self) -> dict:
        """Point-in-time occupancy snapshot (per-step gauge source)."""
        return {
            "tokens_used": self.tokens_used,
            "peak_tokens_used": self.peak_tokens_used,
            "capacity_tokens": self.capacity_tokens,
            "utilization": self.utilization,
            "peak_utilization": self.peak_utilization,
            "slots_in_use": self.slots_in_use,
            "num_slots": self.num_slots,
            "paged": self.paged,
            "page_size": self.page_size if self.paged else 0,
            "pages_used": self.pages_used,
            "peak_pages_used": self.peak_pages_used,
            "total_pages": self.total_pages,
            "page_utilization": self.page_utilization,
            "physical_pages_used": self.physical_pages_used,
            "physical_page_utilization": self.physical_page_utilization,
            "overdraft_pages": self.overdraft_pages,
            "swapped_requests": len(self.host_store),
            "swap_bytes_total": self.swap_bytes_total,
            "swaps_out_total": self.swaps_out_total,
            "drops_total": self.drops_total,
            "dropped_bytes_total": self.dropped_bytes_total,
        }

    # ---- allocation ---------------------------------------------------------
    def _reserve_tokens(self) -> int:
        """Admission headroom: every resident may grow burst_reserve
        tokens before the scheduler re-runs, and so may the candidate."""
        return self.burst_reserve * (self.slots_in_use + 1)

    def can_allocate(self, req: Request, tokens: Optional[int] = None) -> bool:
        need = req.context_len if tokens is None else tokens
        reserve = self._reserve_tokens()
        if not self.free_slots:
            return False
        if self.tokens_used + need + reserve > self.capacity_tokens:
            return False
        if self.paged:
            return (self.pages_used + self.pages_for(need + reserve)
                    <= self.total_pages)
        return True

    def allocate(self, req: Request, tokens: Optional[int] = None) -> int:
        """Claim a slot (and its pages) charging `tokens` of context —
        the full committed context by default; chunked prefill passes the
        first chunk and grows page-by-page as the cursor advances."""
        charge = req.context_len if tokens is None else tokens
        slot = self.free_slots.pop()
        self.slot_of[req.rid] = slot
        self.held_tokens[req.rid] = charge
        self.tokens_used += charge
        self.peak_tokens_used = max(self.peak_tokens_used, self.tokens_used)
        if self.paged:
            self.block_table[req.rid] = [
                self._take_page() for _ in range(self.pages_for(charge))]
        req.engine_slot = slot
        return slot

    def _take_page(self) -> int:
        # the scheduler's watermark keeps demand under capacity, but like
        # the token ledger the pool tolerates transient overdraft (ids
        # past total_pages) instead of corrupting state — utilization > 1
        # is the visible signal, exactly as tokens_used > capacity is
        if self.free_pages:
            page = self.free_pages.pop()
        else:
            page = self.total_pages + self.pages_used
            self.overdraft_pages += 1
        self.version += 1
        self.pages_used += 1
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return page

    def _free_pages_of(self, rid: int, down_to: int = 0) -> int:
        """Return block-table pages beyond `down_to` tokens to the pool
        (partial pages included). Returns the number freed."""
        table = self.block_table.get(rid)
        if table is None:
            return 0
        keep = self.pages_for(down_to)
        freed = table[keep:]
        del table[keep:]
        if freed:
            self.version += 1
        for p in reversed(freed):
            if p < self.total_pages:
                self.free_pages.append(p)
            else:
                self.overdraft_pages -= 1
        self.pages_used -= len(freed)
        if not table:
            self.block_table.pop(rid, None)
        return len(freed)

    def grow(self, req: Request, n: int = 1) -> None:
        """Account for n freshly generated (or freshly prefilled) tokens."""
        self.tokens_used += n
        self.peak_tokens_used = max(self.peak_tokens_used, self.tokens_used)
        rid = req.rid
        if rid in self.held_tokens:
            held = self.held_tokens[rid] + n
            self.held_tokens[rid] = held
            if self.paged:
                table = self.block_table.setdefault(rid, [])
                while len(table) < self.pages_for(held):
                    table.append(self._take_page())

    def ensure_pages(self, req: Request, tokens: int) -> int:
        """Physically pre-extend a resident's block table to cover `tokens`
        total context WITHOUT touching the token ledger — the physical
        engine's block pre-reservation: before dispatching a certified
        j-step decode block it reserves every page the block can write
        (positions up to tokens-1), so the device loop never needs a
        host-side `grow` mid-block. `grow`'s page top-up is idempotent
        against this (it only appends while the table is short), and
        `trim_pages` returns the unused reserve after the commit (EOS
        truncation). Returns pages newly taken."""
        rid = req.rid
        if not self.paged or rid not in self.slot_of:
            return 0
        table = self.block_table.setdefault(rid, [])
        n0 = len(table)
        while len(table) < self.pages_for(tokens):
            table.append(self._take_page())
        return len(table) - n0

    def trim_pages(self, req: Request) -> int:
        """Return pre-reserved pages beyond the committed context (the
        `ensure_pages` reserve a truncated block never wrote) to the pool.
        Returns pages freed."""
        held = self.held_tokens.get(req.rid)
        if held is None:
            return 0
        return self._free_pages_of(req.rid, held)

    def evict_tail(self, req: Request, down_to_tokens: int) -> int:
        """Partial preemption: shrink a resident's footprint to
        `down_to_tokens`, returning its tail pages (the partially filled
        last page included) to the pool. The device row is untouched —
        the cache is length-gated, so the caller only has to stop
        attending past the new length. Returns pages freed."""
        rid = req.rid
        held = self.held_tokens.get(rid)
        if held is None or down_to_tokens >= held:
            return 0
        self.tokens_used -= held - down_to_tokens
        self.held_tokens[rid] = down_to_tokens
        return self._free_pages_of(rid, down_to_tokens)

    def release(self, req: Request) -> None:
        slot = self.slot_of.pop(req.rid)
        self.free_slots.append(slot)
        self.tokens_used -= self.held_tokens.pop(req.rid, req.context_len)
        self._free_pages_of(req.rid)
        req.engine_slot = -1
        self.draft_store.pop(req.rid, None)

    # ---- preemption ---------------------------------------------------------
    def swap_out(self, req: Request, host_slice: dict,
                 draft_slice: Optional[dict] = None) -> None:
        """Park device slices (already fetched to host) and free the slot."""
        self.release(req)                      # also clears any stale draft
        self.host_store[req.rid] = host_slice
        self.swaps_out_total += 1
        self.swap_bytes_total += _slice_bytes(host_slice)
        if draft_slice is not None:
            self.draft_store[req.rid] = draft_slice
            self.swap_bytes_total += _slice_bytes(draft_slice)

    def swap_in(self, req: Request) -> dict:
        return self.host_store.pop(req.rid)

    def swap_in_draft(self, req: Request) -> Optional[dict]:
        return self.draft_store.pop(req.rid, None)

    def drop(self, req: Request) -> None:
        """Recompute-style preemption (or shedding a parked request):
        nothing survives — slot and pages freed, and any parked host
        slices are discarded WITH accounting: `swap_bytes_total` counted
        them in on swap_out, so the discard shows up in
        `dropped_bytes_total` / `drops_total` (occupancy() and the
        kv_* gauges expose both, aligned with the swap counters)."""
        dropped = self.host_store.pop(req.rid, None)
        draft_dropped = self.draft_store.get(req.rid)
        self.dropped_bytes_total += (_slice_bytes(dropped)
                                     + _slice_bytes(draft_dropped))
        self.drops_total += 1
        if req.rid in self.slot_of:
            self.release(req)
        else:
            self.draft_store.pop(req.rid, None)

    @property
    def utilization(self) -> float:
        return self.tokens_used / self.capacity_tokens

    @property
    def page_utilization(self) -> float:
        return self.pages_used / self.total_pages if self.paged else 0.0

    @property
    def physical_pages_used(self) -> int:
        """Pages of the *physical* pool in use: pages_used minus the
        overdraft fictions (ids >= total_pages name no device row).
        This is the figure HBM dashboards must see — at most total_pages
        — while `page_utilization` keeps reporting > 1 under overdraft."""
        return self.pages_used - self.overdraft_pages

    @property
    def physical_page_utilization(self) -> float:
        """Clamped utilization of the physical pool (always <= 1.0)."""
        if not self.paged:
            return 0.0
        return self.physical_pages_used / self.total_pages

    @property
    def peak_utilization(self) -> float:
        """High-water KV occupancy over the manager's lifetime (benchmark
        reporting: confirms the hot-path engine fills the same memory the
        baseline does — the optimizations change dispatch, not packing)."""
        return self.peak_tokens_used / self.capacity_tokens
