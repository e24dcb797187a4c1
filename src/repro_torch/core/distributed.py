"""Scenario ensembles over a device mesh: the lanes of ``simulate_many``
split over ``torch.distributed`` ranks.

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

Job-parallel simulation (``simulate_distributed``, ``lower_distributed``) is
not ported: ROADMAP Queue 1 item 13b.
"""
from __future__ import annotations

import contextlib
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
    simulate,
    simulate_many,
    stack_scenarios,
)
from .types import SimResult

LANE_MODES = ("auto", "scan", "vmap")

_JOB_PARALLEL = (
    "job-parallel simulation is not ported (ROADMAP Queue 1 item 13b): a shard of jobs "
    "cannot score alone, since the policies read cross-job aggregates such as "
    "site_backlog, the start phase sorts every job and every hook sums over sites; "
    "spread scenarios over a mesh with simulate_many_sharded instead")


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


def simulate_distributed(*args, **kw):
    """Job-parallel simulation (the JAX package's jobs sharded over a mesh
    axis): not ported, ROADMAP Queue 1 item 13b; raises."""
    raise NotImplementedError(_JOB_PARALLEL)


def lower_distributed(*args, **kw):
    """The JAX package's XLA lowering of the job-parallel program, which has
    no torch counterpart (ROADMAP Queue 1 item 13b); raises."""
    raise NotImplementedError(_JOB_PARALLEL)
