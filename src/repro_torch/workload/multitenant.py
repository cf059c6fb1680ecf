"""Multi-tenant arrival traces with per-tenant QoE specs (cluster layer).

The paper's traces (Tables 1–2) draw every request's QoE spec from one
user-demographic mix. A fleet serves *tenants* — products with distinct
QoE contracts and traffic shapes: an interactive chat app (stringent TTFT,
reading-speed TDS), a voice assistant (speaking-speed TDS), a background
summarization API (lenient on both). Skewed tenant mixes are exactly the
scenario where QoE-aware routing and admission (repro_torch.cluster, extending
paper §6.4 surge handling fleet-wide) diverge from load-only policies, so
the generator tags each Request with its tenant id for per-tenant
accounting.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.pricing import SLOContract
from repro_torch.core.qoe import QoESpec
from repro_torch.core.request import Request
from repro_torch.workload.arrivals import gamma_arrivals, poisson_arrivals
from repro_torch.workload.qoe_traces import EXPECTED_TTFT, reading_qoe_trace, voice_qoe_trace
from repro_torch.workload.sharegpt import sample_lengths


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic contract."""
    name: str
    share: float                 # fraction of total request volume
    qoe: str = "reading"         # "reading" | "voice" | "fixed"
    ttft: float = EXPECTED_TTFT  # expected TTFT (s); also the fixed-mode TTFT
    tds: float = 4.8             # fixed-mode expected TDS (tokens/s)
    dataset: str = "sharegpt"    # length distribution ("sharegpt"|"multiround")
    weight: float = 1.0          # SLO contract weight (WSC fair share)
    qoe_floor: Optional[float] = None   # per-tenant contract QoE floor
    # access-link scenario this tenant's users sit behind (a key of
    # repro_torch.core.network.NETWORK_SCENARIOS); None = ideal link, which keeps
    # pre-existing workloads byte-identical. Consumers (client buffers,
    # QoE-under-network evaluation) instantiate via `make_network(name)`.
    network: Optional[str] = None

    def contract(self) -> Optional[SLOContract]:
        """SLOContract carried by this tenant's requests — only when the
        tenant departs from the defaults, so pre-arena workloads are
        byte-identical (contract=None prices as weight 1.0 everywhere)."""
        if self.weight == 1.0 and self.qoe_floor is None:
            return None
        return SLOContract(weight=self.weight, qoe_floor=self.qoe_floor)


# A plausible production mix: latency-stringent chat dominates, a voice
# product needs slower-but-steady delivery, and a batch API tolerates long
# TTFT and a trickle TDS (it reads the whole answer at the end).
DEFAULT_TENANTS = (
    TenantSpec("chat", share=0.6, qoe="reading", ttft=1.0),
    TenantSpec("voice", share=0.25, qoe="voice", ttft=1.5),
    TenantSpec("batch_api", share=0.15, qoe="fixed", ttft=10.0, tds=1.5,
               dataset="multiround"),
)


def _tenant_specs(t: TenantSpec, n: int, rng: np.random.Generator) -> List[QoESpec]:
    if t.qoe == "reading":
        return reading_qoe_trace(n, rng, ttft=t.ttft)
    if t.qoe == "voice":
        return voice_qoe_trace(n, rng, ttft=t.ttft)
    if t.qoe == "fixed":
        return [QoESpec(ttft=t.ttft, tds=t.tds)] * n
    raise ValueError(t.qoe)


def make_multitenant_workload(
    n: int,
    rate: float,
    *,
    tenants: Optional[Sequence[TenantSpec]] = None,
    seed: int = 0,
    arrival: str = "gamma",
    cv: float = 3.0,
) -> List[Request]:
    """n requests at aggregate `rate` req/s, tenant drawn per-request from
    the share mix; lengths and QoE specs follow each request's tenant."""
    tenants = list(tenants if tenants is not None else DEFAULT_TENANTS)
    rng = np.random.default_rng(seed)
    shares = np.array([t.share for t in tenants], np.float64)
    shares = shares / shares.sum()
    tenant_ids = rng.choice(len(tenants), size=n, p=shares)

    if arrival == "poisson":
        arrivals = poisson_arrivals(rate, n, rng)
    elif arrival == "gamma":
        arrivals = gamma_arrivals(rate, n, rng, cv=cv)
    else:
        raise ValueError(arrival)

    # draw lengths/specs per tenant (each from that tenant's distribution),
    # then scatter back into arrival order
    prompt = np.zeros(n, np.int64)
    out = np.zeros(n, np.int64)
    specs: List[Optional[QoESpec]] = [None] * n
    for tid, t in enumerate(tenants):
        idx = np.nonzero(tenant_ids == tid)[0]
        if idx.size == 0:
            continue
        p, o = sample_lengths(idx.size, rng, t.dataset)
        prompt[idx], out[idx] = p, o
        for j, s in zip(idx, _tenant_specs(t, idx.size, rng)):
            specs[j] = s

    contracts = [t.contract() for t in tenants]
    return [
        Request(
            rid=i,
            arrival=float(arrivals[i]),
            prompt_len=int(prompt[i]),
            output_len=int(out[i]),
            spec=specs[i],
            tenant=int(tenant_ids[i]),
            contract=contracts[tenant_ids[i]],
        )
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# Adversarial traces (the policy arena's referee workloads)
#
# Each generator builds the scenario a specific policy family is supposed
# to win (or lose) — TokenFlow's synchronized bursts stress preemption,
# heavy-tail prompt mixes stress memory packing, and a greedy tenant
# stresses fairness isolation. All are deterministic in `seed` (pinned by
# tests/test_torch_workload.py) and return plain Request lists, so every backend
# and policy consumes them unchanged.
# ---------------------------------------------------------------------------

def _retag(reqs: List[Request]) -> List[Request]:
    """Re-id in arrival order (backends expect sorted submission)."""
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]


def synchronized_burst_workload(
    n: int,
    rate: float,
    *,
    seed: int = 0,
    burst_every: float = 30.0,
    burst_frac: float = 0.5,
    burst_width: float = 0.5,
    tenants: Optional[Sequence[TenantSpec]] = None,
) -> List[Request]:
    """TokenFlow-style flash crowds: a `burst_frac` share of the traffic
    lands in near-simultaneous spikes every `burst_every` seconds (each
    spike `burst_width`s wide), on top of a smooth background. Buffer-
    aware preemption should absorb the spikes by pausing full-buffer
    requests; FCFS head-of-line blocks on them."""
    base = make_multitenant_workload(n, rate, tenants=tenants, seed=seed,
                                     arrival="poisson")
    rng = np.random.default_rng(seed + 1)
    n_burst = int(n * burst_frac)
    horizon = max(r.arrival for r in base) if base else n / rate
    n_spikes = max(int(horizon // burst_every), 1)
    for r in base[-n_burst:]:
        spike = (1 + int(rng.integers(n_spikes))) * burst_every
        r.arrival = min(spike + float(rng.uniform(0.0, burst_width)),
                        horizon)
    return _retag(base)


def heavy_tail_workload(
    n: int,
    rate: float,
    *,
    seed: int = 0,
    tail_frac: float = 0.1,
    tail_scale: float = 8.0,
    tenants: Optional[Sequence[TenantSpec]] = None,
) -> List[Request]:
    """Heavy-tail prompt mix: a `tail_frac` share of requests carries
    prompts ~`tail_scale`x the tenant's draw (Pareto-style elephants).
    Elephants monopolize KV memory, so packing quality and preemption
    policy dominate; token-counter fairness must not let one tenant's
    elephants starve everyone's mice."""
    base = make_multitenant_workload(n, rate, tenants=tenants, seed=seed)
    rng = np.random.default_rng(seed + 2)
    tail_idx = rng.choice(n, size=max(int(n * tail_frac), 1), replace=False)
    tail = set(int(i) for i in tail_idx)
    out = []
    for r in base:
        if r.rid in tail:
            factor = tail_scale * float(rng.pareto(2.0) + 1.0)
            r = dataclasses.replace(
                r, prompt_len=int(min(r.prompt_len * factor, 8192)))
        out.append(r)
    return _retag(out)


def greedy_tenant_workload(
    n: int,
    rate: float,
    *,
    seed: int = 0,
    greedy_share: float = 0.7,
    greedy_output: int = 512,
    victim_weight: float = 2.0,
    tenants: Optional[Sequence[TenantSpec]] = None,
) -> List[Request]:
    """One-greedy-tenant isolation test: tenant 0 ("greedy") floods
    `greedy_share` of the volume with long outputs at contract weight 1,
    while the well-behaved tenants keep the DEFAULT_TENANTS shapes but
    carry `victim_weight` SLO contracts (they are the paying traffic the
    flood is drowning). A fair policy caps the greedy tenant near its
    entitlement (Jain's index over weight-normalized service stays
    high) — and a *weighted* fair policy (WSC) should beat unweighted
    VTC here, since only it reads the contracts. Throughput-greedy
    policies let the flood starve everyone."""
    tenants = list(tenants if tenants is not None else DEFAULT_TENANTS)
    well_behaved = [dataclasses.replace(
        t, weight=victim_weight,
        share=t.share * (1.0 - greedy_share) / sum(
            x.share for x in tenants))
        for t in tenants]
    mix = [TenantSpec("greedy", share=greedy_share, qoe="fixed",
                      ttft=2.0, tds=6.0)] + well_behaved
    base = make_multitenant_workload(n, rate, tenants=mix, seed=seed)
    rng = np.random.default_rng(seed + 3)
    out = []
    for r in base:
        if r.tenant == 0:     # the greedy tenant demands long generations
            r = dataclasses.replace(
                r, output_len=int(rng.integers(greedy_output // 2,
                                               greedy_output + 1)))
        out.append(r)
    return _retag(out)


ADVERSARIAL_TRACES = {
    "burst": synchronized_burst_workload,
    "heavy_tail": heavy_tail_workload,
    "greedy_tenant": greedy_tenant_workload,
}


def make_adversarial_workload(name: str, n: int, rate: float,
                              **kw) -> List[Request]:
    """Build a named adversarial trace (see ADVERSARIAL_TRACES)."""
    return ADVERSARIAL_TRACES[name](n, rate, **kw)

