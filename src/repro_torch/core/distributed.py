"""Simulation over a device mesh: the lanes of ``simulate_many`` split
over ``torch.distributed`` ranks, and one simulation's dispatch rows split
over them (job-parallel simulation).

The JAX package drives every device of a ``jax.make_mesh((n,), ("data",))``
from one controller and splits the stacked lane axis with ``shard_map``.
Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one
process per device, as ``torchrun`` (or ``torch.multiprocessing.spawn``,
see ``run_ranks``) starts them:

- rank ``r`` of the mesh axis runs the ``r``-th contiguous block of lanes
  (``shard_map``'s ``P(axis)``) on ``cuda:{LOCAL_RANK}``, or on the CPU for
  a ``"cpu"`` mesh (gloo);
- when its block ends, the blocks' results are ``all_gather``ed, so every
  rank returns the whole ``SimResult``, as the reference returns one global
  array.

A rank waits on no other before its block ends: the run is lock-step-free
(DESIGN.md §8).  Every rank calls the entry point with the same arguments
and builds its own policy and subsystems from the same code (closures do not
cross processes); a one-process caller passes a 1-rank mesh (``local_mesh``).  A mesh of
several cards needs ``torchrun --nproc-per-node N`` or ``run_ranks``.

Job-parallel simulation (``simulate_distributed``) runs one simulation on
every rank of a mesh axis.  The JAX package shards the jobs (``jobs.* ->
P(axis)``), replicates the sites and the subsystem states, and leaves XLA to
place the collectives of every cross-job step.  A round has many such steps
(the clock's min-reduction, every per-site sum, the policies' site
aggregates, the start phase's global sort and prefix sums, the float sums of
job memory that decide a start), and a float sum split over ranks changes
its bits.  So here:

- every rank holds the whole padded ``JobsState``, ``SiteState``, subsystem
  states and key, and runs the same round on the same bits (``JobsState`` is
  ~100 B a job); every subsystem works with no code of its own here;
- the dispatch problem, the round's only O(J x S) part, is split by rows:
  rank ``r`` takes rows ``[r B, (r + 1) B)`` with ``B = J_pad / n``
  (``job_block``).  It builds the static feasibility mask and the masked
  score matrix for those rows only and launches the assign kernel (dense)
  or the fused kernel (``topk=``) on them;
- capacity admission is a FIFO in row order in which every claim counts, and
  a row's pick does not depend on the capacities.  So a rank's block is
  admitted behind the lower ranks' claims: one ``all_gather`` of each
  block's integer claims per site (``i32[n, S]``) gives the base that the
  block's positions move up by (``kernels.assign.block_admit``), exact for
  integral sizes (cores), the kernels' own contract;
- one ``all_gather`` of the blocks' picks (``i32[B]`` a rank) gives every
  rank the round's ``[J]`` picks; the rest of the round runs unchanged.

The result equals ``simulate`` on the padded jobs bit for bit, on any
number of ranks.  Only the assigners known to be row-local split
(``engine.default_assign``, ``default_assign_cand`` and the functions of
``make_capacity_assign`` and ``make_fused_capacity_assign``, which carry
``splits_rows``); any other runs on all rows on every rank.  The O(J) work
and memory stay replicated, and a policy whose ``score`` builds ``[J, S]``
(``shortest_wait``, ``random``, ``data_locality``, ``workflow_locality``)
builds it whole on each rank: what more ranks buy is a smaller ``[J, S]``
footprint per card, not speed.  Every rank reaches the same collectives in
the same order, since each host branch reads replicated state; a rank whose
block holds only padding rows joins them all the same, and a 1-rank mesh
runs them too.

``lower_distributed`` counts one round of that program for a mesh without
running it: a trace on meta tensors as rank 0 of the mesh (a fake process
group's, ``launch.mesh.init_fake_world``), counted by
``launch.roofline.Counter``.
"""
from __future__ import annotations

import contextlib
import inspect
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from . import rng as _rng
from .engine import (
    Scenario,
    ScenarioBuckets,
    _check_device,
    _check_ensemble,
    _run_buckets,
    _simulate_many_stacked,
    _tree_map,
    ensemble_scenario,
    init_sim,
    run_sim,
    simulate,
    simulate_many,
    stack_scenarios,
)
from .types import SimResult, pad_jobs_capacity

LANE_MODES = ("auto", "scan", "vmap")


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------


_AMBIENT: list = []   # the meshes of the open use_mesh contexts, innermost last


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block, the mesh that
    ``parallel.sharding``'s ``constrain_batch``, ``maybe_shard_seq`` and
    ``gather_fsdp`` constrain to (JAX's ``jax.set_mesh``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def mesh_device(mesh) -> torch.device:
    """This rank's device: the CPU on a ``"cpu"`` mesh, else
    ``cuda:{LOCAL_RANK}`` (the global rank modulo the host's cards when
    ``LOCAL_RANK`` is unset)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device(mesh.device_type, local)


def _axis_group(mesh, axis: str):
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def lane_block(K: int, mesh, axis: str = "data") -> list[int]:
    """The lanes (indices into ``0..K-1``) that this rank runs of a K-lane
    ensemble: its contiguous block of the lanes padded to a multiple of the
    axis size by repeats of the last lane.  A rank builds a policy that
    carries per-lane state (``make_capacity_assign`` of ``[K, J]`` cores)
    for these lanes, and runs it with ``lane_mode="vmap"``: ``"scan"`` calls
    the policy with one lane's shapes."""
    _, n, r = _axis_group(mesh, axis)
    b = -(-K // n)
    return [min(i, K - 1) for i in range(r * b, (r + 1) * b)]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_mesh_type(device_type: str) -> None:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a card and none is visible; "
                           "pass device_type='cpu' for a gloo mesh on the CPU")


@contextlib.contextmanager
def _process_mesh(device_type: str, world: int, rank: int, init_method: str, axis: str):
    """This process's rank of a 1-D mesh ``(world,)`` named ``axis`` (gloo
    for ``"cpu"``, NCCL on ``cuda:{LOCAL_RANK}`` for ``"cuda"``), its
    process group destroyed on exit."""
    _check_mesh_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host: bootstrap on loopback
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, world_size=world, rank=rank)
    try:
        yield init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))
    finally:
        dist.destroy_process_group()


def local_mesh(device_type: str = "cuda", *, init_method: str | None = None,
               axis: str = "data"):
    """A 1-rank mesh ``(1,)`` named ``axis`` in this process (gloo for
    ``"cpu"``, NCCL for ``"cuda"``, on ``cuda:{LOCAL_RANK}``, default 0),
    destroyed on exit: how a one-process caller runs the mesh entry points.
    A ``"cuda"`` mesh raises where no card is visible.  ``init_method``
    defaults to a free TCP port on localhost."""
    return _process_mesh(device_type, 1, 0, init_method or f"tcp://localhost:{_free_port()}",
                         axis)


def _rank_main(rank, world, fn, args, device_type, init_method, axis):
    os.environ["LOCAL_RANK"] = str(rank)
    with _process_mesh(device_type, world, rank, init_method, axis) as mesh:
        fn(mesh, *args)


def run_ranks(fn, nprocs: int, args: tuple = (), *, device_type: str = "cuda",
              init_method: str | None = None, axis: str = "data") -> None:
    """Start ``nprocs`` processes (``torch.multiprocessing.spawn``), one a
    device, each with a 1-D mesh ``(nprocs,)`` named ``axis`` (gloo on a
    ``"cpu"`` mesh, NCCL on ``"cuda"``, rank ``r`` on ``cuda:r``), and call
    ``fn(mesh, *args)`` in each.  ``fn`` must be importable by the new
    processes (a module-level function); it hands results back through files.
    Raises if any rank raised, after ending the others, and before starting
    any where a ``"cuda"`` mesh finds no card.  ``init_method`` defaults to a
    free TCP port on localhost."""
    import torch.multiprocessing as mp

    _check_mesh_type(device_type)
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    mp.spawn(_rank_main, args=(nprocs, fn, tuple(args), device_type, init_method, axis),
             nprocs=nprocs, join=True)


# --------------------------------------------------------------------------
# gathering a block's result
# --------------------------------------------------------------------------


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda t: out.append(t), tree)
    return out


def _exchange(ok: bool, nbytes: int, group, device) -> torch.Tensor:
    """Every rank's (failed, bytes) once its block ended: ``[n, 2]`` i64."""
    mine = torch.tensor([0 if ok else 1, nbytes], dtype=torch.int64, device=device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return torch.stack(parts).cpu()


def _gather_lanes(res: SimResult, group, device) -> SimResult:
    """The blocks' results of every rank of ``group``, concatenated along
    the lane axis in rank order: the tensor leaves travel as one byte buffer
    a rank (one ``all_gather``); other leaves are this rank's."""
    leaves = [t.to(device) for t in _leaves(res)]
    flat = [t.contiguous().reshape(-1).view(torch.uint8) if t.numel() else
            torch.empty(0, dtype=torch.uint8, device=device) for t in leaves]
    buf = torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8, device=device)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    sizes = [f.numel() for f in flat]
    per_rank = []
    for part in parts:
        chunks = torch.split(part, sizes)
        per_rank.append([c.clone().view(t.dtype).reshape(t.shape)
                         for c, t in zip(chunks, leaves)])
    merged = iter([torch.cat(xs) for xs in zip(*per_rank)])
    return _tree_map(lambda _: next(merged), res)


# --------------------------------------------------------------------------
# sharded scenario ensembles
# --------------------------------------------------------------------------


def _stack_lanes(results: list) -> SimResult:
    """Solo results stacked on a lane axis, as ``simulate_many`` returns
    them: the Python ints of a solo run (``rounds``, ``log.cursor``) become
    i32 lanes."""
    dev = results[0].makespan.device

    def lanes(xs):
        first = xs[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(xs)
        if isinstance(first, int) and not isinstance(first, bool):
            return torch.tensor(xs, dtype=torch.int32, device=dev)
        if isinstance(first, dict):
            return {k: lanes([x[k] for x in xs]) for k in first}
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*(lanes(list(leaf)) for leaf in zip(*xs)))
        if isinstance(first, (tuple, list)):
            return type(first)(lanes(list(leaf)) for leaf in zip(*xs))
        return first

    return lanes(list(results))


def _run_block(block: Scenario, keys, policy, subsystems, lane_mode, device, kw) -> SimResult:
    if lane_mode == "scan":
        solo = []
        for i in range(keys.shape[0]):
            lane = _tree_map(lambda x: x[i], block)
            solo.append(simulate(lane.jobs, lane.sites, policy, keys[i],
                                 subsystems=tuple((sub, lane.ext[sub.name])
                                                  for sub in subsystems),
                                 device=device, **kw))
        return _stack_lanes(solo)
    return _simulate_many_stacked(block, policy, keys, subsystems=subsystems, device=device,
                                  **kw)


def _sharded_stacked(scenarios: Scenario, keys, policy, mesh, axis, subsystems, lane_mode,
                     kw) -> SimResult:
    group, n, r = _axis_group(mesh, axis)
    device = mesh_device(mesh)
    K = scenarios.jobs.arrival.shape[0]
    ix = lane_block(K, mesh, axis)
    err = None
    try:  # every rank must hear of a failure before it gathers
        ext = _check_ensemble(scenarios, subsystems)
        scen = Scenario(scenarios.jobs, scenarios.sites, ext)
        # the lanes stay on the mesh's kind of device; .to only moves a block
        # between cards (cuda:0 to this rank's cuda:r)
        _check_device(scen, torch.device(mesh.device_type), "scenarios")
        pick = torch.tensor(ix, device=scenarios.jobs.arrival.device)
        block = _tree_map(lambda x: x[pick].to(device), scen)
        keys = keys[torch.tensor(ix, device=keys.device)].to(device)
        res = _run_block(block, keys, policy, subsystems, lane_mode, device, kw)
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(res))
    except Exception as e:
        err, nbytes = e, -1
    status = _exchange(err is None, nbytes, group, device)
    if err is not None:
        raise err
    failed = [i for i in range(n) if status[i, 0]]
    if failed:
        raise RuntimeError(f"simulate_many_sharded: rank(s) {failed} of axis {axis!r} failed "
                           "their lane block")
    if len(set(status[:, 1].tolist())) != 1:
        raise RuntimeError(f"simulate_many_sharded: the ranks' block results differ in size "
                           f"({status[:, 1].tolist()} bytes)")
    out = _gather_lanes(res, group, device)
    return _tree_map(lambda x: x[:K], out) if n * len(ix) != K else out


def _resolve_lane_mode(lane_mode: str, mesh) -> str:
    if lane_mode not in LANE_MODES:
        raise ValueError(f"lane_mode must be auto|scan|vmap, got {lane_mode!r}")
    if lane_mode == "auto":
        # solo loops where batching does not pay (the CPU), one batched loop
        # where it does (a card: a round of K lanes costs about one round)
        return "scan" if mesh.device_type == "cpu" else "vmap"
    return lane_mode


def simulate_many_sharded(scenarios, policy, rng: torch.Tensor, mesh, *, axis: str = "data",
                          subsystems: tuple = (), donate: bool | None = None,
                          lane_mode: str = "auto", recorder=None, **kw) -> SimResult:
    """Lock-step-free scenario ensembles over ``mesh[axis]``: the K lanes
    are split into contiguous blocks, rank ``r`` runs block ``r`` on its own
    device in its own round loop, and the results are gathered, so every
    rank returns the whole K-lane ``SimResult`` (on its device).  Lane ``i``
    draws ``split(rng, K)[i]`` on every rank.  Every rank of the axis must
    call this with the same arguments; a rank whose block raises re-raises,
    and every other rank raises too, after its own block.

    ``scenarios`` is a list of ``Scenario``s, a stacked ``Scenario`` or a
    ``ScenarioBuckets`` (each bucket split separately, results merged in the
    original order).  A lane count that does not divide the axis is padded
    with repeats of the last lane, sliced off after the gather.

    ``lane_mode`` says how a rank walks its block: ``"scan"`` runs each lane
    as a solo ``simulate``, one after another, and every lane equals its
    solo run; ``"vmap"`` runs one ``simulate_many`` over the block, and
    every lane equals that call's lane: the phase-skip guard and, with
    ``topk < S`` and ``topk_refresh``, the any-lane refresh rule reduce over
    the block only, so such lanes can depend on the mesh size.  ``"auto"``
    takes ``"scan"`` on a ``"cpu"`` mesh and ``"vmap"`` on cards.

    ``donate`` is accepted for the JAX package's signature and changes
    nothing: torch has no buffer donation.  The scenarios must lie on the
    mesh's device type (any card of a ``"cuda"`` mesh; each rank moves its
    block to its own), and ``device=`` in ``kw``, if given, must name that
    type: nothing moves between the CPU and a card.  ``rng`` moves to the
    rank's device, as ``simulate``'s does.  Other ``kw`` are
    ``simulate_many``'s run options.

    ``recorder`` (a ``telemetry.TraceRecorder``) records the spans
    ``ensemble_stack`` and ``ensemble_run``, the gauges ``lanes``,
    ``mesh_devices``, ``lane_pad_total`` and ``lane_rounds_min/max/mean``,
    and the notes ``lane_mode`` (as passed) and (buckets) ``bucket_padding``."""
    del donate
    device = kw.pop("device", None)
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={device!r} does not match the mesh's {mesh.device_type!r}")
    mode = _resolve_lane_mode(lane_mode, mesh)
    subsystems = tuple(subsystems)
    _, n, _ = _axis_group(mesh, axis)

    def runner(scen, keys):
        return _sharded_stacked(scen, keys, policy, mesh, axis, subsystems, mode, kw)

    buckets = scenarios if isinstance(scenarios, ScenarioBuckets) else None
    if buckets is None and not isinstance(scenarios, Scenario):
        t0 = time.perf_counter()
        scenarios = stack_scenarios(scenarios, subsystems=subsystems)
        if recorder is not None:
            recorder.record("ensemble_stack", time.perf_counter() - t0)
    t0 = time.perf_counter()
    if buckets is not None:
        lanes = [s.jobs.arrival.shape[0] for s in buckets.buckets]
        res = _run_buckets(buckets, rng.to(mesh_device(mesh)), runner, subsystems)
    else:
        lanes = [scenarios.jobs.arrival.shape[0]]
        res = runner(scenarios, _rng.split(rng.to(mesh_device(mesh)), lanes[0]))
    if recorder is None:
        return res
    if res.makespan.is_cuda:
        torch.cuda.synchronize(res.makespan.device)
    recorder.record("ensemble_run", time.perf_counter() - t0)
    rounds = np.asarray(res.rounds.cpu())
    recorder.gauge("lanes", sum(lanes))
    recorder.gauge("mesh_devices", int(mesh.size()))
    recorder.gauge("lane_pad_total", sum((-k) % n for k in lanes))
    recorder.gauge("lane_rounds_min", int(rounds.min()))
    recorder.gauge("lane_rounds_max", int(rounds.max()))
    recorder.gauge("lane_rounds_mean", float(rounds.mean()))
    recorder.note("lane_mode", lane_mode)
    if buckets is not None:
        recorder.note("bucket_padding", buckets.padding_stats())
    return res


def simulate_ensemble_distributed(jobs, sites, policy, rng: torch.Tensor,
                                  speed_candidates: torch.Tensor, mesh, *, axis: str = "data",
                                  availability=None, workflow=None, data_policy=None,
                                  network=None, replicas=None, transfers=None, faults=None,
                                  subsystems=(), **kw) -> SimResult:
    """K per-site speed vectors ``speed_candidates f32[K, S]`` (the
    calibration inner loop) split over ``mesh[axis]``: lane ``i`` is
    ``simulate`` on ``sites._replace(speed=speed_candidates[i])`` under
    ``split(rng, K)[i]``.  K must divide over the axis.  The subsystem
    keywords are ``simulate``'s (each state shared by every lane); ``kw``
    goes to ``simulate_many_sharded``."""
    K = speed_candidates.shape[0]
    _, n, _ = _axis_group(mesh, axis)
    if K % n:
        raise ValueError(f"candidates {K} must divide over {n} devices")
    scn, subs = ensemble_scenario(
        jobs, sites, speed_candidates, availability=availability, workflow=workflow,
        data_policy=data_policy, network=network, replicas=replicas, transfers=transfers,
        faults=faults, subsystems=subsystems)
    return simulate_many_sharded(scn, policy, rng, mesh, axis=axis, subsystems=subs, **kw)


def simulate_population(scenarios, policy, rng: torch.Tensor, *, mesh=None, axis: str = "data",
                        subsystems: tuple = (), **kw) -> SimResult:
    """One entry point for candidate-population ensembles (calibration
    lanes): ``mesh=None`` runs the lanes through ``simulate_many`` on one
    device; a ``DeviceMesh`` spreads them over its ``axis`` through
    ``simulate_many_sharded``, lane counts that do not divide the axis
    padded with repeats and unpadded.  Lane ``i`` draws ``split(rng, K)[i]``
    on both paths.  ``kw`` as for ``simulate_many`` (``device=`` included;
    on a mesh it must name the mesh's device type)."""
    if mesh is None:
        return simulate_many(scenarios, policy, rng, subsystems=subsystems, **kw)
    return simulate_many_sharded(scenarios, policy, rng, mesh, axis=axis,
                                 subsystems=subsystems, **kw)


# --------------------------------------------------------------------------
# job-parallel simulation: one run, its dispatch rows split over the ranks
# --------------------------------------------------------------------------


_SUBSYSTEM_KW = ("data_policy", "network", "replicas", "availability", "workflow", "transfers",
                 "faults")


def _padded_capacity(J: int, n: int) -> int:
    return J + (-J) % n


def job_block(J: int, mesh, axis: str = "data") -> range:
    """The rows of the dispatch problem that this rank solves in a
    job-parallel run of J jobs: its contiguous block of the job capacity
    padded to a multiple of the axis size (``shard_jobs``);
    ``lane_block``'s counterpart."""
    _, n, r = _axis_group(mesh, axis)
    b = _padded_capacity(J, n) // n
    return range(r * b, (r + 1) * b)


def _all_gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated in rank order along dim
    0, as a functional collective (``_c10d_functional``): the form that
    ``launch.roofline.Counter`` counts and that traces on meta tensors."""
    out = torch.ops._c10d_functional.all_gather_into_tensor(x.contiguous(), n,
                                                            group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


class JobBlock:
    """This rank's share of a job-parallel round: rows ``lo:hi`` of the
    ``capacity`` padded jobs, and the round's two collectives over the mesh
    axis's ``group`` of ``n`` ranks (this one ``rank``)."""

    def __init__(self, rows: range, capacity: int, group, n: int, rank: int):
        self.lo, self.hi = rows.start, rows.stop
        self.rows = slice(self.lo, self.hi)
        self.capacity, self.group, self.n, self.rank = capacity, group, n, rank

    @classmethod
    def of(cls, J: int, mesh, axis: str = "data") -> "JobBlock":
        """This rank's block of a J-job run on ``mesh[axis]``."""
        group, n, r = _axis_group(mesh, axis)
        return cls(job_block(J, mesh, axis), _padded_capacity(J, n), group, n, r)

    def gather_picks(self, picks: torch.Tensor) -> torch.Tensor:
        """Every rank's block of picks (``i32[B]``: a site, or -1) as the
        round's ``i32[capacity]``."""
        return _all_gather(picks, self.n, self.group)

    def claims_base(self, claims: torch.Tensor) -> torch.Tensor:
        """Every rank's block claims (``i32[S]``, ``block_claims``) summed over
        the ranks below this one: what the rows before this block claimed."""
        every = _all_gather(claims, self.n, self.group).view(self.n, -1)
        return every[:self.rank].sum(0, dtype=torch.int32)


def job_shardings(mesh, axis: str, jobs, sites):
    """The placements of ``(jobs, sites, rng)`` in a job-parallel run: every
    leaf replicated over ``mesh`` (``(Replicate(),)`` a mesh dimension).  The
    JAX package shards the jobs over ``axis``; here the state stays whole on
    every rank and the dispatch rows are split inside the round (module
    docstring)."""
    from torch.distributed.tensor import Replicate

    _axis_group(mesh, axis)
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    return _tree_map(lambda _: rep, jobs), _tree_map(lambda _: rep, sites), rep


def shard_jobs(jobs, sites, mesh, axis: str = "data"):
    """Place a workload for job-parallel simulation: the job capacity padded
    to a multiple of the axis size with inert rows (``pad_jobs_capacity``:
    DONE, invalid, never dispatched), jobs and sites whole on this rank's
    device (``mesh_device``).  They must lie on the mesh's kind of device."""
    _, n, _ = _axis_group(mesh, axis)
    kind = torch.device(mesh.device_type)
    _check_device(jobs, kind, "jobs")
    _check_device(sites, kind, "sites")
    dev = mesh_device(mesh)
    jobs = pad_jobs_capacity(jobs, _padded_capacity(jobs.capacity, n))
    return _tree_map(lambda x: x.to(dev), jobs), _tree_map(lambda x: x.to(dev), sites)


def _resolve_padded(kw: dict, jobs, sites, old_capacity: int):
    """``(subsystems, padded ext)`` from ``simulate``'s subsystem keywords
    (popped from ``kw``), each state grown to the padded job capacity through
    its subsystem's ``pad_jobs`` hook."""
    from .subsystems import pad_ext_jobs, resolve_subsystems

    subs, ext = resolve_subsystems(
        **{name: kw.pop(name, None) for name in _SUBSYSTEM_KW},
        subsystems=kw.pop("subsystems", ()), jobs=jobs, sites=sites,
        validate=False)   # init_sim validates against the padded shapes
    return subs, pad_ext_jobs(subs, ext, old_capacity, jobs.capacity)


def _prepare_subsystems(kw: dict, jobs, sites, mesh, old_capacity: int) -> dict:
    """``kw`` with the subsystem keywords turned into explicit ``(Subsystem,
    state)`` pairs (``subsystems=``), each state padded to the padded job
    capacity and placed whole on this rank's device, like ``sites``.
    Generic: a new subsystem distributes with no code here."""
    kw = dict(kw)
    subs, ext = _resolve_padded(kw, jobs, sites, old_capacity)
    for name, state in ext.items():
        _check_device(state, torch.device(mesh.device_type), name)
    dev = mesh_device(mesh)
    ext = _tree_map(lambda x: x.to(dev), ext)
    kw["subsystems"] = tuple((sub, ext[sub.name]) for sub in subs)
    return kw


def simulate_distributed(jobs, sites, policy, rng: torch.Tensor, mesh, *, axis: str = "data",
                         horizon: float = float("inf"), recorder=None, device=None,
                         **kw) -> SimResult:
    """Job-parallel simulation: ``simulate``'s semantics and keywords (dense
    or ``topk=``, every subsystem keyword, ``max_rounds``, ``log_rows``,
    ``recorder`` ...), one run spread over ``mesh[axis]`` as the module
    docstring describes.  Every rank returns the padded ``SimResult`` (the
    job capacity padded to a multiple of the axis size) on its device, equal
    bit for bit to ``simulate`` on ``pad_jobs_capacity(jobs, J_pad)``.

    Every rank of the axis calls it with the same arguments and builds its
    own policy and subsystems from the same code; a capacity assigner may
    close over the unpadded jobs' cores.  The inputs lie on the mesh's kind
    of device and each rank runs on ``mesh_device(mesh)``; ``device=``, if
    given, must name the mesh's kind.  A rank that fails inside a round
    leaves the others waiting in that round's collective until the process
    group times out; every rank runs the same code on the same bits, so a
    failure of the code fails them all alike."""
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={device!r} does not match the mesh's {mesh.device_type!r}")
    jobs_d, sites_d = shard_jobs(jobs, sites, mesh, axis)
    kw = _prepare_subsystems(kw, jobs_d, sites_d, mesh, jobs.capacity)
    handle = init_sim(jobs_d, sites_d, policy, rng, device=mesh_device(mesh), **kw)
    handle = handle._replace(job_block=JobBlock.of(jobs.capacity, mesh, axis))
    return run_sim(handle, horizon, recorder)


_RUN_OPTIONS = ("max_rounds", "log_rows", "max_retries", "monitor_every", "quantum", "topk",
                "topk_refresh")
_POLICY_HOOKS = ("init", "score", "assign", "on_step", "rank", "score_cand", "pre_rank",
                 "assign_cand")
_SUBSYSTEM_HOOKS = ("init", "event_times", "arrival_gate", "completion_filter", "on_completions",
                    "pre_assign", "on_start", "log_spec", "log_columns")


def _named(fn, what: str):
    """``fn``, raising a readable error when it reads a meta tensor back."""
    def call(*args, **kw):
        try:
            return fn(*args, **kw)
        except (RuntimeError, NotImplementedError) as e:
            if "meta" not in str(e) or str(e).startswith("lower_distributed"):
                raise
            raise RuntimeError(f"lower_distributed: {what} reads the device back, which a "
                               "trace on meta tensors cannot do") from e

    call.splits_rows = getattr(fn, "splits_rows", False)
    return call


def lower_distributed(jobs, sites, policy, mesh, *, axis: str = "data", **kw) -> dict:
    """The job-parallel program's dry run: one round of
    ``simulate_distributed``'s body, traced on meta tensors as this process's
    rank of ``mesh`` (rank 0 of a fake process group's mesh, see
    ``launch.mesh.init_fake_world``: its collectives move nothing) and
    counted by ``launch.roofline.Counter``; nothing is allocated on a card
    and no kernel runs.  Returns the counter's record, per card: FLOPs, HBM
    bytes, collective bytes by kind, the largest collectives and the peak of
    the round's own results; plus ``ops`` (each op and collective by name, a
    count each), ``ranks``, ``capacity`` (the padded jobs) and
    ``block_rows``.

    The JAX package lowers and compiles the whole loop for the mesh from
    shapes alone.  With no compiler to hand the loop to, this counts one
    round with every phase on: the phase-skip guard off, the host gates
    fixed (a logged round when ``log_rows`` > 0; no candidate rebuild).
    ``kw`` are ``simulate``'s keywords.  The inputs may lie anywhere, meta
    included: the subsystems are resolved and padded where they lie, then
    moved to meta; a policy that closes over tensors (a capacity assigner's
    cores) must close over meta ones.  A round that reads the device back
    (a value deciding a host branch) raises, naming the hook."""
    from ..launch.roofline import Counter
    from .engine import _init_state, _round_fns

    block = JobBlock.of(jobs.capacity, mesh, axis)
    kw = {k: v for k, v in kw.items() if k not in ("horizon", "recorder", "device", "phase_skip")}
    subs, ext = _resolve_padded(kw, pad_jobs_capacity(jobs, block.capacity), sites, jobs.capacity)
    unknown = sorted(set(kw) - set(_RUN_OPTIONS))
    if unknown:
        raise TypeError(f"lower_distributed() got unexpected keyword arguments {unknown}")
    defaults = inspect.signature(init_sim).parameters
    opts = {k: kw.get(k, defaults[k].default) for k in _RUN_OPTIONS}
    if opts["topk"] is not None:
        opts["topk"] = min(int(opts["topk"]), sites.capacity)

    def meta(x):
        return x.to("meta")

    subs = tuple(sub._replace(**{
        h: _named(getattr(sub, h), f"the {sub.name!r} subsystem's {h} hook")
        for h in _SUBSYSTEM_HOOKS if getattr(sub, h) is not None}) for sub in subs)
    policy = policy._replace(**{
        h: _named(getattr(policy, h), f"policy {policy.name!r}'s {h}")
        for h in _POLICY_HOOKS if getattr(policy, h) is not None})
    st = _init_state(pad_jobs_capacity(_tree_map(meta, jobs), block.capacity),
                     _tree_map(meta, sites), policy, _rng.PRNGKey(0, device="meta"),
                     _tree_map(meta, ext), subs, opts["log_rows"], opts["topk"])
    _, body = _round_fns(policy, subs, **opts, phase_skip=False, job_block=block)
    with Counter() as counter:
        body(st, None, (opts["log_rows"] > 0, False))
    rec = counter.record()
    rec.update(ops=dict(counter.ops), ranks=block.n, capacity=block.capacity,
               block_rows=block.hi - block.lo)
    return rec
