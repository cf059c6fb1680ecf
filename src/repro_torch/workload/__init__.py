from repro_torch.workload.arrivals import gamma_arrivals, poisson_arrivals
from repro_torch.workload.multitenant import (
    ADVERSARIAL_TRACES,
    DEFAULT_TENANTS,
    TenantSpec,
    greedy_tenant_workload,
    heavy_tail_workload,
    make_adversarial_workload,
    make_multitenant_workload,
    synchronized_burst_workload,
)
from repro_torch.workload.qoe_traces import reading_qoe_trace, voice_qoe_trace
from repro_torch.workload.sharegpt import make_workload, sample_lengths

__all__ = [
    "poisson_arrivals",
    "gamma_arrivals",
    "reading_qoe_trace",
    "voice_qoe_trace",
    "sample_lengths",
    "make_workload",
    "TenantSpec",
    "DEFAULT_TENANTS",
    "make_multitenant_workload",
    "ADVERSARIAL_TRACES",
    "make_adversarial_workload",
    "synchronized_burst_workload",
    "heavy_tail_workload",
    "greedy_tenant_workload",
]
