"""Storage elements and the replica catalog.

Grid jobs read *datasets* that live on storage elements at specific sites;
where the replicas are decides stage-in time.  Dense representation over D
datasets x S sites:

  present[D, S]      replica catalog (bool)
  size[D]            dataset bytes
  origin[D]          pinned home site, the authoritative copy, never evicted
  disk_used[S]/cap   storage-element occupancy
  last_access[D, S]  LRU clock for capacity eviction

Every operation (source selection, cache-on-read insertion, masked LRU
eviction) is fixed-shape masked tensor algebra with the JAX package's float
order: the column sums over datasets are ``scan.sum_f32`` and the LRU
prefix is ``scan.cumsum_f32``, because ``disk_used`` decides which replicas
are evicted.  Scatters that may meet one cell twice are written so the
result does not depend on the order the card applies them in.

In an ensemble every field leads with the lane axis (``present [K, D, S]``,
counters ``[K]``) and each operation works lane by lane; the eviction
path's host read becomes "does any lane evict", which is exact because a
lane without pressure gets the same values from either path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .scan import cumsum_f32, sum_f32
from .types import per_lane, resolve_device, take

INF = float("inf")

# calls of insert_mask that took the evicting path (some site over capacity),
# since the count was last reset
evicting_calls = 0


class ReplicaState(NamedTuple):
    present: torch.Tensor      # bool[D, S] replica catalog
    size: torch.Tensor         # f32[D] dataset bytes
    origin: torch.Tensor       # i32[D] home site (pinned copy), -1 = not yet produced
    disk_used: torch.Tensor    # f32[S] bytes resident per storage element
    disk_cap: torch.Tensor     # f32[S] storage-element capacity
    last_access: torch.Tensor  # f32[D, S] last read/insert time (LRU)
    n_hits: torch.Tensor       # i32[] cumulative local cache hits
    n_transfers: torch.Tensor  # i32[] cumulative WAN transfers
    bytes_moved: torch.Tensor  # f32[] cumulative WAN bytes

    @property
    def n_datasets(self) -> int:
        return self.present.shape[-2]

    @property
    def n_sites(self) -> int:
        return self.present.shape[-1]


def _host(x):
    """A tensor (any device) as numpy; anything else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _col_bytes(mask: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """``(mask * size[:, None]).sum(0)``: bytes per site, summed over the
    datasets (the axis before the sites) in XLA's order."""
    return sum_f32(torch.where(mask, size[..., :, None], 0.0), -2)


def _drop_fill(n: int, idx: torch.Tensor, keep: torch.Tensor, value, like: torch.Tensor):
    """A copy of ``like`` (``n`` cells a lane) with ``value`` written at the
    flat cell ``idx`` where ``keep``; the other rows go to a spare slot that
    is cut off (the JAX package's ``mode="drop"``).  Every written cell gets
    the same value, so repeated indices give one result on every device.
    With lanes (``idx [K, J]``) each lane writes its own cells."""
    total = like.numel()
    if idx.dim() > 1:
        lanes = idx.shape[:-1]
        idx = idx + torch.arange(0, total, n, device=idx.device).view(*lanes, 1)
    flat = torch.cat([like.reshape(-1), like.new_empty((1,))])
    flat.index_fill_(0, torch.where(keep, idx, total).long().reshape(-1), value)
    return flat[:total].view(like.shape)


def make_replicas(sizes, disk_capacity, *, origin=None, placement=None, materialized=None,
                  seed: int = 0, device="cuda") -> ReplicaState:
    """Build a catalog: one pinned origin replica per dataset plus optional
    extra ``placement`` (bool[D, S]).  Default origins are drawn by capacity
    weight (big storage elements hold more data).

    ``materialized`` (bool[D], default all True) marks datasets that exist at
    t=0; False rows start with no replica anywhere and ``origin = -1``:
    intermediate workflow outputs that a job materializes mid-run through
    ``materialize_outputs``.
    """
    device = resolve_device(device)
    size = torch.from_numpy(np.asarray(_host(sizes), np.float32).copy()).to(device)
    cap = torch.from_numpy(np.asarray(_host(disk_capacity), np.float32).copy()).to(device)
    D, S = size.shape[0], cap.shape[0]
    mat = np.ones(D, bool) if materialized is None else np.asarray(_host(materialized), bool)
    if origin is None:
        rng = np.random.default_rng(seed)
        w = np.maximum(cap.cpu().numpy().astype(np.float64), 0.0)
        w = w / max(w.sum(), 1e-9)
        origin = np.where(mat, rng.choice(S, size=D, p=w), -1)
    origin = torch.from_numpy(np.asarray(_host(origin)).astype(np.int32)).to(device)
    seeded = torch.from_numpy(mat).to(device) & (origin >= 0)
    present = torch.zeros((D, S), dtype=torch.bool, device=device)
    present[torch.arange(D, device=device), origin.clamp(0, S - 1).long()] = seeded
    if placement is not None:
        present = present | torch.as_tensor(np.asarray(_host(placement), bool), device=device)
    return ReplicaState(
        present=present,
        size=size,
        origin=origin,
        disk_used=_col_bytes(present, size),
        disk_cap=cap,
        last_access=torch.where(present, 0.0, -INF),
        n_hits=torch.zeros((), dtype=torch.int32, device=device),
        n_transfers=torch.zeros((), dtype=torch.int32, device=device),
        bytes_moved=torch.zeros((), dtype=torch.float32, device=device),
    )


def materialize_outputs(rep: ReplicaState, dataset: torch.Tensor, site: torch.Tensor,
                        mask: torch.Tensor, clock) -> ReplicaState:
    """Row-wise output production: where ``mask[j]``, dataset ``dataset[j]``
    comes into existence at ``site[j]`` and that copy becomes the dataset's
    pinned origin.  When two rows produce one dataset in the same call, the
    row with the higher index sets the origin, as XLA's scatter does on the
    CPU; both sites get a replica.

    Like ``make_replicas``' origin copies, the authoritative copy bypasses
    the capacity check; only policy-managed caches are capacity-bound.
    """
    D, S = rep.present.shape[-2:]
    d = dataset.clamp(0, D - 1).long()
    s = site.clamp(0, S - 1).long()
    dd = torch.where(mask, d, D)
    rows = torch.arange(d.shape[-1], device=d.device)
    last = torch.full((*d.shape[:-1], D + 1), -1, dtype=torch.int64,
                      device=d.device).scatter_reduce(
        -1, dd, torch.where(mask, rows, -1), reduce="amax")[..., :D]
    origin = torch.where(last >= 0, take(s, last.clamp_min(0)).int(), rep.origin)
    add = _drop_fill(D * S, d * S + s, mask, True, torch.zeros_like(rep.present))
    new = add & ~rep.present
    return rep._replace(
        present=rep.present | add,
        origin=origin,
        disk_used=rep.disk_used + _col_bytes(new, rep.size),
        last_access=torch.where(add, per_lane(clock, 2), rep.last_access),
    )


def zipf_dataset_sizes(n_datasets: int, *, seed: int = 0, mean_bytes: float = 20e9,
                       sigma: float = 1.0) -> np.ndarray:
    """Log-normal dataset sizes (HEP AOD/DAOD-flavoured heavy tail)."""
    rng = np.random.default_rng(seed)
    return rng.lognormal(np.log(mean_bytes), sigma, n_datasets).astype(np.float32)


# --------------------------------------------------------------------------
# source selection
# --------------------------------------------------------------------------


def nearest_source(rep: ReplicaState, net, dataset: torch.Tensor,
                   dst: torch.Tensor) -> torch.Tensor:
    """Best replica site for each job: minimize the unshared transfer time
    ``latency[src, dst] + size / bw[src, dst]`` over sites holding a replica,
    the first site on ties.

    Local replicas win (the diagonal link is ~free).  Rows whose dataset has
    no *reachable* replica fall back to the pinned origin.  Unreachable
    sources (zero or NaN bandwidth, non-finite latency) are masked out of the
    cost's operands and of the argmin, so no sentinel enters the division.
    """
    D = rep.present.shape[-2]
    d = dataset.clamp(0, D - 1).long()
    dst = dst.long()
    lat = take(net.latency.transpose(-2, -1), dst, tail=1)   # [J, S] latency[src, dst_j]
    bw = take(net.bw.transpose(-2, -1), dst, tail=1)         # [J, S]
    reach = take(rep.present, d, tail=1) & (bw > 0) & torch.isfinite(lat)
    lat_s = torch.where(reach, lat, 0.0)
    bw_s = torch.where(reach, bw.clamp_min(1e-9), 1.0)
    cost = torch.where(reach, lat_s + take(rep.size, d)[..., None] / bw_s, INF)
    src = cost.argmin(-1).int()
    return torch.where(reach.any(-1), src, take(rep.origin, d))


# --------------------------------------------------------------------------
# cache insertion with masked LRU eviction
# --------------------------------------------------------------------------


def insert_mask(rep: ReplicaState, want: torch.Tensor, clock) -> ReplicaState:
    """Insert replicas for every True cell of ``want[D, S]``, evicting LRU
    non-origin replicas per site to make room.  Sites that cannot fit a new
    replica even after evicting everything evictable skip the insertion, so
    ``disk_used <= disk_cap`` is an invariant (given a valid initial state).

    The LRU machinery (a ``[D, S]`` sort) runs only in calls where some site
    would go over capacity; the JAX package guards it with a ``lax.cond``,
    the port with one read of that flag on the host.  Without pressure both
    paths give the same values.  ``evicting_calls`` counts the calls that
    took the evicting path.
    """
    global evicting_calls
    new = want & ~rep.present
    incoming = _col_bytes(new, rep.size)
    need = (rep.disk_used + incoming - rep.disk_cap).clamp_min(0.0)
    if bool((need > 0.0).any()):
        evicting_calls += 1
        return _insert_mask_evicting(rep, want, new, incoming, need, clock)
    return rep._replace(
        present=rep.present | new,
        disk_used=rep.disk_used + incoming,
        last_access=torch.where(new, per_lane(clock, 2), rep.last_access),
    )


def _insert_mask_evicting(rep: ReplicaState, want, new, incoming, need, clock) -> ReplicaState:
    """The LRU-eviction path of ``insert_mask`` (see its docstring)."""
    S = rep.present.shape[-1]
    is_origin = (torch.arange(S, device=want.device)
                 == rep.origin.clamp(0, S - 1)[..., None])
    # candidates: resident, not the pinned origin, not read or inserted now
    evictable = rep.present & ~is_origin & ~want
    # a stable sort: ties (the inf of non-candidates) keep dataset order
    key = torch.where(evictable, rep.last_access, INF) + 0.0
    order = torch.sort(key, dim=-2, stable=True).indices                 # [D, S]
    ev_sorted = evictable.gather(-2, order)
    sz_sorted = torch.where(ev_sorted, take(rep.size, order), 0.0)
    cum_excl = cumsum_f32(sz_sorted, -2) - sz_sorted
    evict_sorted = ev_sorted & (cum_excl < need[..., None, :])
    evict = torch.zeros_like(evict_sorted).scatter_(-2, order, evict_sorted)
    freed = _col_bytes(evict, rep.size)

    # drop insertions at sites that still do not fit after all eviction
    fits = rep.disk_used - freed + incoming <= rep.disk_cap + 1e-3
    do_insert = new & fits[..., None, :]
    kept_in = _col_bytes(do_insert, rep.size)
    # a site only evicts if its insertions land
    evict = evict & fits[..., None, :]
    freed = torch.where(fits, freed, 0.0)
    return rep._replace(
        present=(rep.present & ~evict) | do_insert,
        disk_used=rep.disk_used - freed + kept_in,
        last_access=torch.where(do_insert, per_lane(clock, 2),
                                torch.where(evict, -INF, rep.last_access)),
    )


def insert_replicas(rep: ReplicaState, dataset: torch.Tensor, site: torch.Tensor,
                    mask: torch.Tensor, clock) -> ReplicaState:
    """Row-wise insertion: cache ``dataset[j]`` at ``site[j]`` where
    ``mask[j]`` (an OR over rows that name one cell)."""
    D, S = rep.present.shape[-2:]
    d = dataset.clamp(0, D - 1).long()
    s = site.clamp(0, S - 1).long()
    want = _drop_fill(D * S, d * S + s, mask, True, torch.zeros_like(rep.present))
    return insert_mask(rep, want, clock)


def touch(rep: ReplicaState, dataset: torch.Tensor, site: torch.Tensor, mask: torch.Tensor,
          clock) -> ReplicaState:
    """Refresh the LRU clock of the replicas read this round (where
    present): every touched cell receives the same clock."""
    D, S = rep.present.shape[-2:]
    d = dataset.clamp(0, D - 1).long()
    s = site.clamp(0, S - 1).long()
    on = mask & take(rep.present.flatten(-2), d * S + s)
    hit = _drop_fill(D * S, d * S + s, on, True, torch.zeros_like(rep.present))
    return rep._replace(last_access=torch.where(hit, per_lane(clock, 2), rep.last_access))


def catalog_invariants(rep: ReplicaState) -> dict:
    """Numpy invariant checks: capacity respected, accounting exact, origins
    pinned."""
    present = _host(rep.present)
    size = _host(rep.size)
    used = _host(rep.disk_used)
    cap = _host(rep.disk_cap)
    origin_raw = _host(rep.origin)
    origin = np.clip(origin_raw, 0, present.shape[1] - 1)
    recomputed = (present * size[:, None]).sum(0)
    # origin < 0: declared but never materialized (e.g. the producer was
    # cascade-cancelled), exempt from the pinned-copy check
    has_origin = origin_raw >= 0
    # a pinned copy is present and was never swept by the LRU (-inf
    # last_access is the eviction sentinel)
    rows = np.arange(present.shape[0])
    last = _host(rep.last_access)
    origin_pinned_ok = bool(
        (present[rows, origin][has_origin] & np.isfinite(last[rows, origin][has_origin])).all()
    )
    return dict(
        capacity_ok=bool((used <= cap + 1e-2).all()),
        accounting_ok=bool(np.allclose(used, recomputed, rtol=1e-5, atol=1.0)),
        origins_ok=bool(present[np.arange(present.shape[0]), origin][has_origin].all()),
        origin_pinned_ok=origin_pinned_ok,
    )
