"""Composable engine subsystems: the round loop as an ordered phase pipeline.

Each engine extension is a ``Subsystem``: a bundle of hook functions the
engine calls at fixed points of every event round, with all of the
subsystem's dynamic state in one slot of the generic ``EngineState.ext``
mapping (a dict keyed by subsystem name).  A run without a subsystem runs
no code of it, and a subsystem that draws randomness does so from its own
key stream (``RoundCtx.subkey``), so attaching one never perturbs another's
results.  The protocol is the JAX package's, hook for hook:

  phase (engine round)       | hook
  ---------------------------+------------------------------------------------
  0. pre-run                 | validate(sub, state0, jobs, sites)   may raise
                             | init(sub, state0, jobs, sites) -> ext
  1. clock min-reduction     | event_times(sub, ctx) -> f32[] next event time
     arrivability            | arrival_gate(sub, ctx) -> bool[J]  (also step 3)
  2. completions             | completion_filter(sub, ctx, comp) -> bool[J]
  2b/2c. post-completion     | on_completions(sub, ctx)      state transitions
  4. assignment              | pre_assign(sub, ctx)   feasibility/speed mods
  5b. starts                 | on_start(sub, ctx)     service-time adjustments
  6. event log               | log_columns(sub, ctx, write) -> {name: [S] col}
                             |   (write: True, or an ensemble's bool[K])
     (declaration)           | log_spec(sub, ext, jobs, sites) -> {name: [S]}
  end of run                 | finalize(sub, ext, jobs, sites, clock)
                             |   -> (ext, {SimResult field: value})
  capacity padding (host)    | pad_jobs(sub, state0, old_J, new_J) -> state0

Hooks fire in subsystem-tuple order within each phase; the built-ins come
first in the JAX package's order (availability, workflow, data, transfers,
faults), then explicit ``subsystems=`` pairs in caller order.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, NamedTuple

from . import rng as _rng

# fold_in salt separating the subsystem key tree from the engine's own
# split(key, 4) stream (see RoundCtx.subkey)
_SUBKEY_SALT = 0x5B5D5


class Subsystem(NamedTuple):
    """Hook bundle for one engine extension (see the module docstring).

    ``config`` carries run-constant settings; all run-time state lives in
    ``EngineState.ext[name]``."""

    name: str
    config: Any = None
    init: Callable | None = None
    validate: Callable | None = None
    event_times: Callable | None = None
    arrival_gate: Callable | None = None
    completion_filter: Callable | None = None
    on_completions: Callable | None = None
    pre_assign: Callable | None = None
    on_start: Callable | None = None
    log_spec: Callable | None = None
    log_columns: Callable | None = None
    finalize: Callable | None = None
    pad_jobs: Callable | None = None


def make_subsystem(name: str, **hooks) -> Subsystem:
    """Convenience constructor: ``make_subsystem("scratch", on_start=f, ...)``."""
    return Subsystem(name=name, **hooks)


class RoundCtx:
    """Mutable context threaded through one engine round.

    The engine rebuilds it every round from the ``EngineState``, hooks read
    and replace its fields, and the engine collects them into the next
    ``EngineState``.  Fields a hook may read/write:

      jobs, sites        current JobsState / SiteState (replace to transition)
      ext                dict name -> subsystem state (replace your slot)
      clock_prev, clock  round entry time / this round's event time
      comp, done_now, failed_now   completion masks (set by the engine, step 2)
      arrived            this round's arrival mask (engine, step 3)
      feasible           bool[J, S] assignment feasibility (AND your mask in);
                         sparse top-k mode carries a bool[1, S] site mask
      start_cores        i32[S] cores the start phase may claim this round
      sites_serv         SiteState used for service-time pricing (speed mods)
      started, site_c, share, start_site   start-phase masks (engine, step 5)
      t_serv             f32[J] service time of starting jobs (override/adjust)
      progressed         OR in a bool[] if your transitions made progress
                         (``ctx.progressed = ctx.progressed | mask.any()``)
      scratch            per-round dict for passing values between your hooks
      max_retries, S, J  run constants

    Stochastic subsystems draw through ``subkey(name)``: a per-round,
    per-subsystem key folded off the round's carry key without consuming
    it, so their draws never shift the engine's own stream.
    """

    def __init__(self, *, jobs, sites, ext, clock_prev, max_retries, rng=None):
        self.jobs = jobs
        self.sites = sites
        self.ext = ext
        self.clock_prev = clock_prev
        self.clock = clock_prev
        self.max_retries = max_retries
        self.rng = rng
        self.S = sites.capacity
        self.J = jobs.capacity
        self.comp = None
        self.done_now = None
        self.failed_now = None
        self.arrived = None
        self.feasible = None
        self.start_cores = None
        self.sites_serv = None
        self.started = None
        self.site_c = None
        self.share = None
        self.start_site = None
        self.t_serv = None
        self.progressed = False
        self.scratch = {}

    def subkey(self, name: str, salt: int = 0):
        """This round's key for subsystem ``name`` (``salt`` for extra
        streams): ``fold_in`` of the round's carry key by ``_SUBKEY_SALT``,
        then by the CRC-32 of the name, then by ``salt`` when it is not 0.
        The same bits as the JAX package's key for the same run, round,
        name and salt."""
        if self.rng is None:
            raise ValueError("RoundCtx.subkey needs the engine round key (rng=)")
        key = _rng.fold_in(self.rng, _SUBKEY_SALT)
        key = _rng.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
        return _rng.fold_in(key, salt) if salt else key


def resolve_subsystems(
    *,
    data_policy=None,
    network=None,
    replicas=None,
    availability=None,
    workflow=None,
    transfers=None,
    faults=None,
    subsystems=(),
    jobs=None,
    sites=None,
    validate=True,
):
    """Normalize the engine's keyword API into ``(tuple of Subsystem, ext0
    dict)``: ``availability=``, ``workflow=``, ``data_policy=`` (with
    ``network=`` and ``replicas=``), ``transfers=`` and ``faults=`` map onto
    the built-in subsystems in that order, followed by explicit
    ``subsystems=((Subsystem, state0), ...)`` pairs in caller order.  The
    ``validate`` hooks run here, and the faults subsystem's channel flags
    are read from its state on the host.

    ``data_policy=`` needs both ``network=`` and ``replicas=``, and
    ``transfers=`` needs the data subsystem (it owns the WAN matrices and the
    catalog): both raise ``ValueError`` otherwise, as in the JAX package."""
    pairs: list[tuple[Subsystem, Any]] = []
    if availability is not None:
        from .availability import availability_subsystem

        pairs.append((availability_subsystem(), availability))
    if workflow is not None:
        from .workflows import workflow_subsystem

        pairs.append((workflow_subsystem(), workflow))
    if data_policy is not None:
        if network is None or replicas is None:
            raise ValueError("data_policy requires both network= and replicas=")
        from .datapolicies import data_subsystem

        pairs.append((data_subsystem(data_policy), (network, replicas)))
    if transfers is not None:
        if data_policy is None:
            raise ValueError(
                "transfers= requires the data subsystem (data_policy= with "
                "network=/replicas=): it owns the WAN matrices and catalog")
        from .transfers import transfers_subsystem

        pairs.append((transfers_subsystem(), transfers))
    if faults is not None:
        from .faults import faults_subsystem

        pairs.append((faults_subsystem(faults), faults))
    for entry in subsystems:
        if isinstance(entry, Subsystem):
            raise TypeError(
                f"subsystems entries are (Subsystem, state0) pairs; got bare "
                f"Subsystem {entry.name!r}; pass ({entry.name}, state0)"
            )
        sub, state0 = entry
        pairs.append((sub, state0))

    names = [sub.name for sub, _ in pairs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate subsystem names: {sorted(names)}")
    if validate:
        for sub, state0 in pairs:
            if sub.validate is not None:
                sub.validate(sub, state0, jobs, sites)
    return tuple(sub for sub, _ in pairs), {sub.name: state0 for sub, state0 in pairs}


def pad_ext_jobs(subsystems, ext: dict, old_capacity: int, new_capacity: int) -> dict:
    """Grow job-capacity-shaped subsystem state through each subsystem's
    ``pad_jobs`` hook."""
    if new_capacity == old_capacity:
        return ext
    out = dict(ext)
    for sub in subsystems:
        if sub.pad_jobs is not None and sub.name in out:
            out[sub.name] = sub.pad_jobs(sub, out[sub.name], old_capacity, new_capacity)
    return out
