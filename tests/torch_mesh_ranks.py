"""Rank functions for the port's spawned mesh tests (``run_ranks``).

This module imports neither ``jax`` nor ``repro``, so a spawned rank starts
in the time it takes to import torch and the port.  Each function builds
its inputs with the port's own functions (every rank the same), runs the
entry point on its rank of the mesh, and saves every tensor of the result by
its path to ``<out>/rank<r>.pt``.  The tests compare those files with a
one-process run.
"""
from __future__ import annotations

import pathlib

import torch

import repro_torch.core as T
import repro_torch.core.calibration as TC
from repro_torch.core.distributed import (
    lane_block,
    local_mesh,
    mesh_device,
    simulate_distributed,
    simulate_ensemble_distributed,
    simulate_many_sharded,
)
from repro_torch.core.rng import PRNGKey
from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign


def flat(tree, prefix: str = "") -> dict:
    """Every tensor leaf of a result by its path (other leaves dropped)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def one_rank_mesh(tmp_path):
    """A 1-rank gloo ``"cpu"`` mesh named ``("data",)`` in this process
    (``file://`` rendezvous in ``tmp_path``), destroyed on exit."""
    return local_mesh("cpu", init_method=f"file://{tmp_path}/rendezvous")


def ragged_lanes(K: int, n_sites: int = 4):
    """K ragged lanes: sites at speed x (0.8 + 0.1 i), 30 + 7 i jobs."""
    sites = T.atlas_like_platform(n_sites, seed=1, device="cpu")
    return [T.Scenario(T.synthetic_panda_jobs(30 + 7 * i, seed=20 + i, duration=600.0,
                                              device="cpu"),
                       sites._replace(speed=sites.speed * (0.8 + 0.1 * i)))
            for i in range(K)]


def _save(mesh, out, tree) -> None:
    rank = mesh.get_local_rank("data")
    torch.save({k: v.cpu() for k, v in flat(tree).items()},
               pathlib.Path(out) / f"rank{rank}.pt")


def lanes_rank(mesh, out: str, K: int, lane_mode: str, seed: int) -> None:
    res = simulate_many_sharded(ragged_lanes(K), T.get_policy("panda_dispatch"),
                                PRNGKey(seed), mesh, lane_mode=lane_mode, log_rows=8)
    _save(mesh, out, res)


def contended_jobs(n: int, seed: int = 7, device="cpu"):
    """``n`` jobs that all arrive at t = 0 and want 1, 2 or 4 cores each, far
    more than ``contended_sites`` holds: the first round's FIFO admission
    binds within the first few rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return T.make_jobs(job_id=np.arange(n), arrival=np.zeros(n), work=rng.uniform(50, 500, n),
                       cores=rng.choice([1, 2, 4], n), memory=rng.uniform(1, 4, n),
                       bytes_in=rng.uniform(1e6, 1e8, n), bytes_out=rng.uniform(1e6, 1e7, n),
                       device=device)


def contended_sites(device="cpu"):
    return T.make_sites(cores=[12, 8], speed=[10.0, 8.0], memory=[64.0, 64.0],
                        bw_in=[1e9, 5e8], bw_out=[1e9, 1e9], device=device)


def job_parallel_case(kind: str, device="cpu"):
    """``(jobs, sites, policy, kw)`` of a job-parallel run: ``"dense"``, 30
    contended jobs under ``panda_dispatch`` with capacity dispatch;
    ``"fused"``, the same jobs under ``data_locality`` with the fused
    capacity assign at ``topk=1``; ``"padding"``, 4 of them (over 3 ranks
    the last rank's block holds only padding rows).  Built on ``device``."""
    jobs = contended_jobs(4 if kind == "padding" else 30, device=device)
    kw = dict(max_rounds=400, log_rows=8)
    if kind == "fused":
        policy = T.with_fused_assign(T.get_policy("data_locality"),
                                     make_fused_capacity_assign(jobs.cores))
        kw["topk"] = 1
    else:
        policy = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                        make_capacity_assign(jobs.cores))
    return jobs, contended_sites(device), policy, kw


def job_parallel_rank(mesh, out: str, kinds: tuple) -> None:
    """Each case of ``kinds`` in turn on this rank's device, its result in
    ``<out>/<kind>/``."""
    for kind in kinds:
        jobs, sites, policy, kw = job_parallel_case(kind, mesh_device(mesh))
        res = simulate_distributed(jobs, sites, policy, PRNGKey(3), mesh, **kw)
        (pathlib.Path(out) / kind).mkdir(exist_ok=True)
        _save(mesh, pathlib.Path(out) / kind, res)


def calibration_problem():
    """A 60-job, 3-site engine-trace problem over speeds and WAN links."""
    problem, _ = TC.make_synthetic_platform_problem(60, 3, seed=2, include=("speed", "bw"),
                                                    trace="engine", device="cpu")
    return problem


CALIBRATE_KW = dict(method="spsa", objective="engine", include=("speed", "bw"), n_iters=3,
                    seed=1, max_rounds=400, spsa_dirs=2)


def calibrate_rank(mesh, out: str) -> None:
    fit = TC.calibrate_platform(calibration_problem(), mesh=mesh, **CALIBRATE_KW)
    _save(mesh, out, fit)


def failing_rank(mesh, out: str) -> None:
    """Rank 1's block raises (its lanes carry a wrong subsystem tuple); the
    other ranks must raise too rather than wait."""
    scen = ragged_lanes(4)
    subs = (T.availability_subsystem(),) if mesh.get_local_rank("data") == 1 else ()
    simulate_many_sharded(scen, T.get_policy("panda_dispatch"), PRNGKey(0), mesh,
                          subsystems=subs)


def uneven_ensemble_rank(mesh, out: str) -> None:
    """Three speed candidates over the mesh: raises on two ranks."""
    sites = T.atlas_like_platform(4, seed=1, device="cpu")
    jobs = T.synthetic_panda_jobs(20, seed=0, duration=600.0, device="cpu")
    simulate_ensemble_distributed(jobs, sites, T.get_policy("panda_dispatch"), PRNGKey(0),
                                  sites.speed[None].repeat(3, 1), mesh)


def card_lanes_rank(mesh, out: str, K: int) -> None:
    """K lanes at S = 50 on this rank's card, ``panda_dispatch`` with
    capacity dispatch for this rank's lanes (its own policy)."""
    dev = mesh_device(mesh)
    stacked = T.stack_scenarios(card_lanes(K, dev))
    _save(mesh, out, simulate_many_sharded(stacked, card_policy(stacked, lane_block(K, mesh)),
                                           PRNGKey(3), mesh, max_rounds=300))


def card_lanes(K: int, device):
    sites = T.atlas_like_platform(50, seed=1, fail_rate=0.02, device=device)
    return [T.Scenario(T.synthetic_panda_jobs(300 + 60 * i, seed=10 + i, duration=3600.0,
                                              device=device),
                       sites._replace(speed=sites.speed * (0.7 + 0.1 * i)))
            for i in range(K)]


def card_policy(stacked, lanes):
    """Capacity dispatch over the cores of ``lanes`` of ``stacked``."""
    from repro_torch.kernels.assign import make_capacity_assign

    cores = stacked.jobs.cores[torch.tensor(lanes, device=stacked.jobs.cores.device)]
    return T.with_capacity_assign(T.get_policy("panda_dispatch"), make_capacity_assign(cores))


def restore_sharded_rank(mesh, out: str, ckpt_dir: str, arch: str, opt_8bit: bool,
                         shape: tuple) -> None:
    """Restore a checkpoint of ``arch``'s smoke ``TrainState`` with
    ``shardings=params_shardings(...)`` on a ``("data", "model")`` mesh of
    ``shape`` over the ranks; save each leaf's local shard, its placements
    and this rank's mesh coordinate.  Then, under ``use_mesh``, one layer's
    module-form shardings through ``device_put``, ``gather_fsdp`` and a
    batch through ``constrain_batch`` and ``maybe_shard_seq``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import get_smoke
    from repro_torch.core.distributed import use_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import (NamedSharding, PartitionSpec, batch_shardings,
                                      constrain_batch, device_put, gather_fsdp, maybe_shard_seq,
                                      params_shardings)
    from repro_torch.train import init_train_state, train_state_to_tree

    torch.set_num_threads(1)   # four ranks on the same cores
    grid = init_device_mesh(mesh.device_type, shape, mesh_dim_names=("data", "model"))
    cfg = get_smoke(arch)
    state = init_train_state(build_model(cfg, device="cpu"), 0, opt_8bit=opt_8bit)
    template = train_state_to_tree(state, cfg)
    tree, step = restore(ckpt_dir, template, shardings=params_shardings(template, grid))
    rec = {"coordinate": list(grid.get_coordinate()), "step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        rec["leaves"][key] = (leaf.to_local().clone(), [str(p) for p in leaf.placements],
                              tuple(leaf.shape))
    layer = {name[len("layers.0."):]: p for name, p in state.params.named_parameters()
             if name.startswith("layers.0.")}
    shard = params_shardings(state.params, grid, cfg)
    dts = {}   # the layer's parameters as DTensors, nested by their dotted names
    for name, p in layer.items():
        *outer, last = name.split(".")
        node = dts
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = device_put(p.detach(), shard["layers.0." + name])
    tokens = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    batch = device_put(tokens, batch_shardings({"x": tokens}, grid)["x"])
    rec["plain"] = constrain_batch(tokens) is tokens
    with use_mesh(grid):
        gathered = gather_fsdp(dts)
        seq = maybe_shard_seq(batch)
        rec["seq"] = ([str(p) for p in seq.placements], seq.to_local().clone())
        replicated = batch.redistribute(grid, NamedSharding(grid, PartitionSpec()).placements())
        constrained = constrain_batch(replicated)
        rec["batch"] = ([str(p) for p in constrained.placements], constrained.to_local().clone())
        rec["plain_in_mesh"] = constrain_batch(tokens) is tokens
    rec["layer"] = {key: ([str(p) for p in g.placements], g.to_local().clone(),
                         g.full_tensor().clone(), [str(p) for p in _flatten(dts)[key].placements])
                    for key, g in _flatten(gathered).items()}
    torch.save(rec, pathlib.Path(out) / f"rank{torch.distributed.get_rank()}.pt")


def launch_train_batch(cfg, B: int = 4, S: int = 16) -> dict:
    """The same tokens on every rank (seeded numpy)."""
    import numpy as np

    rng = np.random.default_rng(11)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}


def recorded_train_step(model, opt_cfg, microbatches: int):
    """``make_train_step``'s step, and a dict that each call fills with the
    gradients the step hands AdamW (f32, by parameter name)."""
    from unittest import mock

    from repro_torch.train import train_step as TS

    grads: dict = {}
    inner = TS.adamw_update

    def update(cfg, named, g, opt, **kw):
        grads.clear()
        grads.update(g)
        return inner(cfg, named, g, opt, **kw)

    with mock.patch.object(TS, "adamw_update", update):
        step = TS.make_train_step(model, opt_cfg, microbatches=microbatches)
    return step, grads


# the decode check: a 6-token prompt, then 4 teacher-forced tokens against a
# cache of 16 positions, so that kv_len (6 .. 9) crosses the boundary at 8
# of a cache split in two over 'model'
DECODE_CACHE_LEN, DECODE_PROMPT, DECODE_NEW = 16, 6, 4


def launch_decode(model, params, tokens, place=lambda cache: cache, *,
                  prompt: int = DECODE_PROMPT, new: int = DECODE_NEW):
    """Prefill ``tokens``' first ``prompt`` positions into a cache of
    ``DECODE_CACHE_LEN`` (``place`` puts it on a mesh), then decode the next
    ``new`` tokens one at a time -> (each step's logits, the cache)."""
    cache = place(model.init_cache(tokens.shape[0], DECODE_CACHE_LEN))
    logits, cache = model.prefill(params, {"tokens": tokens[:, :prompt]}, cache)
    out = [logits]
    for i in range(prompt, prompt + new):
        logits, cache = model.decode(params, tokens[:, i:i + 1], cache)
        out.append(logits)
    return out, cache


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def launch_rank(mesh, out: str, arch: str, shape: tuple, microbatches: int,
                windows: tuple) -> None:
    """On a ``("data", "model")`` grid of ``shape`` over the ranks, under
    ``use_mesh``: one ``make_train_step`` step of ``arch``'s f32 smoke
    config with the ``TrainState`` as ``DTensor``s
    (``launch.specs.shard_train_state``) and the batch split over 'data',
    saving the loss, every gradient the step computed and every parameter
    after it; then, for each attention window in ``windows``, a prefill and
    decode steps (``launch_decode``) with the parameters and the cache placed
    by ``params_shardings``/``cache_shardings`` (the cache's positions split
    over 'model'), and a prefill that fills the whole cache, saving the
    logits and the cache.  Every tensor saved whole (``full_tensor``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke
    from repro_torch.core.distributed import use_mesh
    from repro_torch.launch.specs import _place, shard_train_state, sharded_params
    from repro_torch.models import build_model
    from repro_torch.parallel import NamedSharding, PartitionSpec, cache_shardings, device_put
    from repro_torch.train import AdamWConfig, init_train_state

    torch.set_num_threads(1)
    grid = init_device_mesh(mesh.device_type, shape, mesh_dim_names=("data", "model"))
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    state = shard_train_state(init_train_state(model, 0), grid, cfg)
    tokens = launch_train_batch(cfg)["tokens"]
    split = NamedSharding(grid, PartitionSpec("data", None))
    step, grads = recorded_train_step(model, AdamWConfig(warmup_steps=1, eps=1.0),
                                      microbatches)
    rec = {}
    with use_mesh(grid), implicit_replication():
        state, met = step(state, {"tokens": device_put(tokens, split)})
        rec["loss"] = float(_whole(met["loss"]))
        rec["grads"] = {n: _whole(g) for n, g in grads.items()}
        rec["params"] = {n: _whole(p) for n, p in state.params.named_parameters()}

        def place(cache):
            tensors = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
            return _place(cache, cache_shardings(tensors, grid, batch=("data",)))

        runs = {f"decode{w}": (w, {}) for w in windows}
        runs["prefill_full"] = (0, dict(prompt=DECODE_CACHE_LEN, new=0))
        for name, (window, kw) in runs.items():
            wmodel = build_model(cfg.replace(window=window), device="cpu")
            logits, cache = launch_decode(wmodel, sharded_params(wmodel, grid),
                                          device_put(tokens, split), place, **kw)
            rec[name] = ([_whole(x) for x in logits],
                         {k: _whole(v) for k, v in cache.items() if isinstance(v, torch.Tensor)})
    torch.save(rec, pathlib.Path(out) / f"rank{torch.distributed.get_rank()}.pt")
