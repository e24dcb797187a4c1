"""Data-movement policies: the second plugin family, beside ``Policy``.

A ``DataPolicy`` is a bundle of functions with the same extension points as
the JAX package's:

    hook                     | DataPolicy field
    -------------------------+-------------------------------------------------
    getResourceInformation   | init(jobs, sites, network, replicas)
                             |   -> (replicas, data_state)   (pre-placement)
    assignJob (data half)    | select_source(jobs, sites, network, replicas,
                             |   state, dst, clock) -> i32[J] replica site
                             | should_cache(jobs, sites, network, replicas,
                             |   state, dst, clock) -> bool[J] cache-on-read
    onJobEnd                 | on_step(state, jobs, replicas, started, xfer,
                             |   clock) -> state
    onSimulationEnd          | on_end(state, jobs, replicas, clock) -> state

The data subsystem (``data_subsystem``) prices the stage-in of dataset jobs
as a WAN read from the selected replica over the shared link matrix and
keeps the catalog (LRU touches, cache-on-read insertion, counters); with the
transfer-queue subsystem attached it hands those reads to the link queues
instead, and ``land_deferred`` applies the bookkeeping when they land.

Every hook is lane-generic: in an ensemble the network, the catalog and the
jobs lead with the lane axis, lookups go through ``types.take`` and the
counters sum over the last axis, so each lane keeps its own books.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .network import link_value
from .replicas import ReplicaState, insert_mask, nearest_source
from .scan import sum_f32
from .types import take


class DataPolicy(NamedTuple):
    name: str
    init: Callable
    select_source: Callable
    should_cache: Callable
    on_step: Callable
    on_end: Callable


def _default_init(jobs, sites, network, replicas):
    return replicas, ()


def _default_select(jobs, sites, network, replicas, state, dst, clock):
    return nearest_source(replicas, network, jobs.dataset, dst)


def _never_cache(jobs, sites, network, replicas, state, dst, clock):
    return torch.zeros(jobs.dataset.shape, dtype=torch.bool, device=jobs.dataset.device)


def _always_cache(jobs, sites, network, replicas, state, dst, clock):
    return torch.ones(jobs.dataset.shape, dtype=torch.bool, device=jobs.dataset.device)


def _keep_state(state, *_):
    return state


def make_data_policy(name: str, *, init=None, select_source=None, should_cache=None,
                     on_step=None, on_end=None) -> DataPolicy:
    return DataPolicy(
        name=name,
        init=init or _default_init,
        select_source=select_source or _default_select,
        should_cache=should_cache or _never_cache,
        on_step=on_step or _keep_state,
        on_end=on_end or _keep_state,
    )


# --------------------------------------------------------------------------
# the data Subsystem: replica-aware stage-in as hooks on the round loop.  The
# DataPolicy rides in ``sub.config``; the ext slot carries the network, the
# catalog, the policy state and the WAN-ingress accumulator.
# --------------------------------------------------------------------------


class DataExt(NamedTuple):
    """The data subsystem's ``EngineState.ext["data"]`` slot."""

    network: object          # NetworkState link matrices (read-only in the loop)
    replicas: ReplicaState
    state: object            # DataPolicy-defined value
    net_acc: torch.Tensor    # f32[S] WAN bytes staged since the last log write


def _data_init(sub, state0, jobs, sites):
    network, replicas = state0
    replicas, dstate = sub.config.init(jobs, sites, network, replicas)
    return DataExt(network=network, replicas=replicas, state=dstate,
                   net_acc=torch.zeros(replicas.disk_used.shape, dtype=torch.float32,
                                       device=replicas.size.device))


def _data_on_start(sub, ctx):
    """Replica-aware stage-in (engine step 5b): dataset jobs swap the flat
    latency + stage-in terms for a WAN transfer from the policy-selected
    replica, with catalog bookkeeping (LRU touch, cache-on-read insertion,
    hit and transfer counters)."""
    from .engine import _site_sum, service_time, stage_in_time
    from .network import shared_transfer_times
    from .replicas import insert_replicas, touch

    policy = sub.config
    dext = ctx.ext["data"]
    network, rep, dstate = dext.network, dext.replicas, dext.state
    jobs, sites, S = ctx.jobs, ctx.sites, ctx.S
    started, site_c, share, start_site = ctx.started, ctx.site_c, ctx.share, ctx.start_site
    clock = ctx.clock

    has_ds = jobs.dataset >= 0
    # only flat-link stage-ins share the site's ingress link; dataset jobs
    # stage over the WAN matrix instead
    n_flat_start = _site_sum(started & ~has_ds, start_site, S)
    share_in = take(n_flat_start, site_c).float()
    t_serv = service_time(jobs, ctx.sites_serv, site_c, share_in, share)
    D = rep.present.shape[-2]
    d_c = jobs.dataset.clamp(0, D - 1).long()
    ds_bytes = take(rep.size, d_c)
    local = take(rep.present.flatten(-2), d_c * S + site_c)
    read = started & has_ds
    src = policy.select_source(jobs, sites, network, rep, dstate, site_c, clock)
    src_c = src.clamp(0, S - 1)
    xfer = read & ~local
    in_flat = stage_in_time(jobs, ctx.sites_serv, site_c, share_in)
    # with the transfer-queue subsystem attached, WAN reads go to its link
    # queues instead of being priced now: the staging gate and the landing
    # happen in transfers.py
    defer = "transfers" in ctx.ext
    if defer:
        ctx.t_serv = torch.where(has_ds, t_serv - in_flat, t_serv)
    else:
        t_net, _ = shared_transfer_times(network, src_c, site_c, ds_bytes, xfer)
        ctx.t_serv = torch.where(has_ds, t_serv - in_flat + t_net, t_serv)
    rep = touch(rep, jobs.dataset, src_c, xfer, clock)
    rep = touch(rep, jobs.dataset, site_c, read & local, clock)
    want_cache = policy.should_cache(jobs, sites, network, rep, dstate, site_c, clock) & xfer
    moved = torch.where(xfer, ds_bytes, 0.0)
    rep = rep._replace(n_hits=rep.n_hits + (read & local).sum(-1).int())
    net_in_now = dext.net_acc
    if defer:
        # hand this round's WAN reads to the transfer queues; the replica
        # insertion and the WAN counters land at transfer completion
        ctx.scratch["transfers"] = {
            "xfer": xfer,
            "link": src_c.int() * S + site_c.int(),
            "bytes": moved,
            "resid": (t_serv - in_flat).clamp_min(0.0) + link_value(network.latency, src_c,
                                                                     site_c),
            "cache": want_cache,
        }
        t_net_col = torch.zeros_like(moved)
    else:
        rep = insert_replicas(rep, jobs.dataset, site_c, want_cache, clock)
        rep = rep._replace(
            n_transfers=rep.n_transfers + xfer.sum(-1).int(),
            bytes_moved=rep.bytes_moved + sum_f32(moved, -1),
        )
        net_in_now = net_in_now + _site_sum(moved, torch.where(xfer, jobs.site, S), S)
        t_net_col = t_net
    ctx.jobs = jobs._replace(
        xfer_src=torch.where(read, src_c.int(), jobs.xfer_src),
        xfer_bytes=torch.where(read, moved, jobs.xfer_bytes),
        xfer_time=torch.where(read, t_net_col, jobs.xfer_time),
    )
    dstate = policy.on_step(dstate, ctx.jobs, rep, started, xfer, clock)
    ctx.ext["data"] = DataExt(network=network, replicas=rep, state=dstate, net_acc=net_in_now)


def land_deferred(dext: DataExt, jobs, done, cache, clock, S) -> DataExt:
    """Deferred landing of queue-managed transfers: the catalog and WAN
    bookkeeping that ``_data_on_start`` skips when the transfer queues are
    attached, applied to the ``done`` rows at completion (a replica at the
    destination, the transfer and byte counters, per-site WAN ingress)."""
    from .engine import _site_sum
    from .replicas import insert_replicas

    rep = insert_replicas(dext.replicas, jobs.dataset, jobs.site.clamp(0, S - 1), done & cache,
                          clock)
    moved = torch.where(done, jobs.xfer_bytes, 0.0)
    rep = rep._replace(
        n_transfers=rep.n_transfers + done.sum(-1).int(),
        bytes_moved=rep.bytes_moved + sum_f32(moved, -1),
    )
    net_in = _site_sum(moved, torch.where(done, jobs.site, S), S)
    return dext._replace(replicas=rep, net_acc=dext.net_acc + net_in)


def _data_log_spec(sub, dext: DataExt, jobs, sites):
    return {"site_disk": dext.replicas.disk_used, "site_net_in": dext.net_acc}


def _data_log_columns(sub, ctx, write):
    dext = ctx.ext["data"]
    cols = {"site_disk": dext.replicas.disk_used, "site_net_in": dext.net_acc}
    # WAN ingress accumulates between log writes, so monitor_every > 1 still
    # conserves bytes in the exported timeline; it resets on a write (in an
    # ensemble, in the lanes that write: ``write`` is then ``bool[K]``)
    if isinstance(write, torch.Tensor):
        net_acc = torch.where(write[..., None], 0.0, dext.net_acc)
    else:
        net_acc = torch.zeros_like(dext.net_acc) if write else dext.net_acc
    ctx.ext["data"] = dext._replace(net_acc=net_acc)
    return cols


def _data_finalize(sub, dext: DataExt, jobs, sites, clock):
    dstate = sub.config.on_end(dext.state, jobs, dext.replicas, clock)
    dext = dext._replace(state=dstate)
    return dext, {"replicas": dext.replicas, "data_state": dstate}


def data_subsystem(policy: DataPolicy):
    """Data movement as an engine subsystem.  Its initial state is the
    ``(NetworkState, ReplicaState)`` pair; the DataPolicy rides in
    ``config``."""
    from .subsystems import Subsystem

    return Subsystem(
        name="data",
        config=policy,
        init=_data_init,
        on_start=_data_on_start,
        log_spec=_data_log_spec,
        log_columns=_data_log_columns,
        finalize=_data_finalize,
    )


# --------------------------------------------------------------------------
# built-in data policies
# --------------------------------------------------------------------------


def always_remote() -> DataPolicy:
    """Read from the nearest replica, never cache: every job whose dataset is
    not already local pays a WAN transfer."""
    return make_data_policy("always_remote")


def cache_on_read() -> DataPolicy:
    """Nearest-replica reads, and every remote read inserts a replica at the
    compute site (LRU-evicting under storage pressure): the volatile cache."""
    return make_data_policy("cache_on_read", should_cache=_always_cache)


def pre_place_hot(hot_frac: float = 0.1, n_copies: int = 3, cache: bool = False) -> DataPolicy:
    """Replicate the hottest ``hot_frac`` of datasets (by job count in the
    submitted workload) to the ``n_copies`` largest storage elements before
    the run (in an ensemble, each lane's own hottest datasets and largest
    storage elements)."""

    def init(jobs, sites, network, replicas: ReplicaState):
        from ..kernels.segment_sum import segment_sum

        D = replicas.present.shape[-2]
        d = jobs.dataset.clamp(0, D - 1)
        has = jobs.valid & (jobs.dataset >= 0)
        counts = segment_sum(has.int(), torch.where(has, d, D), D)
        k = max(int(round(hot_frac * D)), 1)
        rank = torch.sort(-counts, dim=-1, stable=True).indices
        hot = torch.zeros(counts.shape, dtype=torch.bool, device=counts.device)
        hot.scatter_(-1, rank[..., :k], True)
        # + 0.0: a zero capacity sorts as one zero, as JAX ties -0.0 and 0.0
        cap = replicas.disk_cap
        targets = torch.sort(-cap + 0.0, dim=-1, stable=True).indices[..., :n_copies]
        target_mask = torch.zeros(cap.shape, dtype=torch.bool, device=cap.device)
        target_mask.scatter_(-1, targets, True)
        want = hot[..., :, None] & target_mask[..., None, :]
        return insert_mask(replicas, want, 0.0), ()

    return make_data_policy(
        f"pre_place_hot({hot_frac},{n_copies})",
        init=init,
        should_cache=_always_cache if cache else _never_cache,
    )


DATA_REGISTRY: dict[str, Callable[..., DataPolicy]] = {
    "always_remote": always_remote,
    "cache_on_read": cache_on_read,
    "pre_place_hot": pre_place_hot,
}


def get_data_policy(name: str, **params) -> DataPolicy:
    if name not in DATA_REGISTRY:
        raise KeyError(f"unknown data policy {name!r}; have {sorted(DATA_REGISTRY)}")
    return DATA_REGISTRY[name](**params)


def register_data(name: str):
    """Decorator: plug a user data-policy factory into the registry."""

    def deco(fn):
        DATA_REGISTRY[name] = fn
        return fn

    return deco


# --------------------------------------------------------------------------
# abstract-class adapter, as ``policies.AllocationPlugin`` is for Policy
# --------------------------------------------------------------------------


class DataPlugin:
    """Subclass and override, then call ``.build()`` to get a DataPolicy."""

    name = "custom_data"

    def get_resource_information(self, jobs, sites, network, replicas):
        return replicas, ()

    def select_source(self, jobs, sites, network, replicas, state, dst, clock):
        return nearest_source(replicas, network, jobs.dataset, dst)

    def should_cache(self, jobs, sites, network, replicas, state, dst, clock):
        return torch.zeros(jobs.dataset.shape, dtype=torch.bool, device=jobs.dataset.device)

    def on_transfer(self, state, jobs, replicas, started, xfer, clock):
        return state

    def on_simulation_end(self, state, jobs, replicas, clock):
        return state

    def build(self) -> DataPolicy:
        return DataPolicy(
            name=self.name,
            init=self.get_resource_information,
            select_source=self.select_source,
            should_cache=self.should_cache,
            on_step=self.on_transfer,
            on_end=self.on_simulation_end,
        )
