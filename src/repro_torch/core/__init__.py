"""CGSim core on PyTorch: the event-round engine (``engine.simulate``,
``init_sim``/``advance_sim``/``finish_sim`` for segmented runs, and scenario
ensembles on a lane axis: ``simulate_many``, ``simulate_ensemble``) and its
sparse top-k candidate index (``sparse``), the subsystem protocol
(``subsystems``) with site availability (``availability``), workflow DAGs
(``workflows``), data movement (``network``, ``replicas``,
``datapolicies``) with FTS-style transfer queues (``transfers``) and fault
injection (``faults``), the plugin policy system (``policies``),
PanDA-shaped workloads, calendars and fault scenarios (``workload``), the
JSON input layer and platform builders (``platform``), metrics, the
event-level ML dataset (``events``), the flight recorder (``telemetry``),
monitoring (``monitor``, with ``watch``), calibration (``calibration``:
the Fig. 3 optimizers, ``calibrate_platform`` over engine lanes or
``torch.autograd`` of the closed form; ``distributed.simulate_population``
runs its lanes), and the numpy bridge (``convert``).
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
    take,
)
from .engine import (  # noqa: F401
    Scenario,
    ScenarioBuckets,
    SimHandle,
    advance_sim,
    compute_time,
    default_assign,
    default_assign_cand,
    finish_sim,
    init_sim,
    queue_times,
    service_time,
    sim_active,
    simulate,
    simulate_ensemble,
    simulate_many,
    stack_scenarios,
    walltimes,
)
from .telemetry import (  # noqa: F401
    CallbackSink,
    MemorySink,
    NDJSONSink,
    NullRecorder,
    NullSink,
    Sink,
    TraceRecorder,
    iter_ndjson,
    jsonable,
    lane_occupancy,
    manifest_drift,
    read_manifest,
    run_manifest,
    scenario_hash,
    write_manifest,
)
from .subsystems import (  # noqa: F401
    RoundCtx,
    Subsystem,
    make_subsystem,
    pad_ext_jobs,
    resolve_subsystems,
)
from .availability import (  # noqa: F401
    AvailabilityState,
    availability_factor,
    availability_subsystem,
    downtime_fraction,
    make_availability,
    next_window_edge,
    sample_correlated_outages,
)
from .network import (  # noqa: F401
    NetworkState,
    atlas_like_network,
    link_caps,
    link_index,
    matrix_network,
    network_from_sites,
    shared_transfer_times,
    star_network,
    tiered_network,
    uniform_network,
    with_bandwidth,
)
from .replicas import (  # noqa: F401
    ReplicaState,
    catalog_invariants,
    insert_replicas,
    make_replicas,
    materialize_outputs,
    nearest_source,
    zipf_dataset_sizes,
)
from .datapolicies import (  # noqa: F401
    DataExt,
    DataPlugin,
    DataPolicy,
    data_subsystem,
    get_data_policy,
    make_data_policy,
    register_data,
)
from .transfers import (  # noqa: F401
    TransferState,
    make_transfers,
    transfers_subsystem,
)
from .faults import (  # noqa: F401
    BL_CLOSED,
    BL_HALF_OPEN,
    BL_TRIPPED,
    FaultState,
    FaultsConfig,
    faults_subsystem,
    make_faults,
)
from .policies import (  # noqa: F401
    REGISTRY,
    AllocationPlugin,
    Policy,
    get_policy,
    make_policy,
    critical_path_first,
    register,
    with_capacity_assign,
    with_fused_assign,
)
from .workflows import (  # noqa: F401
    WorkflowScenario,
    WorkflowState,
    atlas_mc_workflows,
    chain_workflows,
    make_workflow,
    map_reduce_workflows,
    parent_status,
    scenario_replicas,
    validate_workflow_data,
    workflow_locality,
    workflow_subsystem,
)
from .sparse import bytes_per_round, build_candidates, static_feasibility  # noqa: F401
from .workload import (  # noqa: F401
    flaky_grid,
    flaky_sites,
    from_records,
    lm_job_records,
    lossy_links,
    maintenance_calendar,
    replica_loss_calendar,
    rolling_brownout,
    synthetic_panda_jobs,
)
from .platform import (  # noqa: F401
    ExecutionParams,
    apply_site_params,
    atlas_like_platform,
    deactivate_sites,
    dump_platform,
    load_availability,
    load_faults,
    load_platform,
)
from .metrics import Metrics, compute_metrics, summary_str  # noqa: F401
from .events import read_ml_trace, recorded_trace, stream_rows, write_ml_dataset  # noqa: F401
from .calibration import (  # noqa: F401
    CalibProblem,
    CalibResult,
    PlatformBounds,
    PlatformCalibResult,
    PlatformParams,
    PlatformProblem,
    calibrate,
    calibrate_platform,
    default_bounds,
    make_population_objective,
    make_synthetic_platform_problem,
    platform_objective,
    platform_params,
    platform_problem_from_trace,
    recovery_error,
)
from .convert import (  # noqa: F401
    availability_from_numpy,
    calib_problem_from_numpy,
    faults_from_numpy,
    jobs_from_numpy,
    network_from_numpy,
    platform_problem_from_numpy,
    replicas_from_numpy,
    result_to_numpy,
    scenario_from_numpy,
    sites_from_numpy,
    transfers_from_numpy,
    workflow_from_numpy,
)
from .rng import PRNGKey  # noqa: F401
from .monitor import watch  # noqa: F401
