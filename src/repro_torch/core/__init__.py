"""QoE definition + QoE-aware scheduling (host code shared by every engine)."""
from repro_torch.core.latency_model import (
    A40_4X,
    A100_4X,
    TPU_V5E,
    TPU_V5E_POD,
    HardwareSpec,
    LatencyModel,
    SpeculativeLatencyModel,
)
from repro_torch.core.objectives import (
    FLEET_OBJECTIVES,
    fleet_avg_qoe,
    fleet_min_qoe,
    fleet_slo_attainment,
)
from repro_torch.core.pricing import (
    QoEPricer,
    SLOContract,
    placement_gain,
    request_weight,
    shared_token_rate,
    slo_attained,
    weighted_attainment,
)
from repro_torch.core.qoe import (
    FluidQoE,
    QoESpec,
    pace_delivery,
    predict_request_qoe,
    qoe_exact,
)
from repro_torch.core.scoring import (
    fairness_report,
    jains_index,
    max_min_service,
    per_tenant_service,
    slo_goodput,
)
from repro_torch.core.network import (
    NETWORK_SCENARIOS,
    JitterLossLink,
    NetworkModel,
    make_network,
    qoe_under_network,
)
from repro_torch.core.token_buffer import TokenBuffer
from repro_torch.core.policies import (
    SCHEDULERS,
    AndesDPScheduler,
    AndesScheduler,
    BurstPreemptiveScheduler,
    FCFSScheduler,
    RoundRobinScheduler,
    Scheduler,
    SchedulerConfig,
    SchedulingPolicy,
    VTCScheduler,
    WSCScheduler,
    make_scheduler,
)

__all__ = [
    "QoESpec", "FluidQoE", "pace_delivery", "qoe_exact", "predict_request_qoe",
    "FLEET_OBJECTIVES", "fleet_avg_qoe", "fleet_min_qoe", "fleet_slo_attainment",
    "HardwareSpec", "LatencyModel", "SpeculativeLatencyModel",
    "TPU_V5E", "TPU_V5E_POD", "A100_4X", "A40_4X",
    "Scheduler", "SchedulerConfig", "SchedulingPolicy",
    "FCFSScheduler", "RoundRobinScheduler",
    "AndesScheduler", "AndesDPScheduler",
    "VTCScheduler", "WSCScheduler", "BurstPreemptiveScheduler",
    "SCHEDULERS", "make_scheduler",
    "QoEPricer", "SLOContract", "placement_gain", "request_weight",
    "shared_token_rate", "slo_attained", "weighted_attainment",
    "jains_index", "slo_goodput", "per_tenant_service", "max_min_service",
    "fairness_report",
    "TokenBuffer",
    "NetworkModel", "JitterLossLink", "NETWORK_SCENARIOS", "make_network",
    "qoe_under_network",
]
