"""CGSim core on PyTorch: the event-round engine (``engine.simulate``), the
plugin policy system (``policies``), PanDA-shaped workloads (``workload``),
platform builders (``platform``), metrics, and the numpy bridge (``convert``).
"""
from .types import (  # noqa: F401
    ASSIGNED,
    CANCELLED,
    DONE,
    FAILED,
    JOB_PAD_FILLS,
    N_STATES,
    PENDING,
    QUEUED,
    RUNNING,
    STATE_NAMES,
    EngineState,
    EventLog,
    JobsState,
    SimResult,
    SiteState,
    make_jobs,
    make_log,
    make_sites,
    pad_jobs_capacity,
)
from .engine import compute_time, default_assign, service_time, simulate  # noqa: F401
from .policies import (  # noqa: F401
    REGISTRY,
    AllocationPlugin,
    Policy,
    get_policy,
    make_policy,
    register,
    with_capacity_assign,
)
from .workload import synthetic_panda_jobs  # noqa: F401
from .platform import atlas_like_platform  # noqa: F401
from .metrics import Metrics, compute_metrics, summary_str  # noqa: F401
from .convert import jobs_from_numpy, result_to_numpy, sites_from_numpy  # noqa: F401
from .rng import PRNGKey  # noqa: F401
