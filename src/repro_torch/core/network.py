"""Inter-site network topology: the data-movement half of the input layer.

The WAN is a pair of dense ``f32[S, S]`` matrices (bandwidth and latency,
src -> dst) built from simple topology specs (star hub, tiered, or an
explicit matrix), with per-round equal-share bandwidth among concurrent
transfers on one directed link.  The builders take the same numpy draws as
the JAX package's, so both packages build the same matrices from a seed.

Directed links are also a flattened index space, ``src * S + dst``: the
per-link counts of ``link_shares`` and the transfer-queue subsystem's link
state live there, as sums over ``S * S + 1`` segments (the last one the
padding for non-participating rows).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.segment_sum import segment_sum
from .types import resolve_device, take

LOCAL_BW = 1e15  # bytes/s stand-in for "no WAN hop" (same-site read)


class NetworkState(NamedTuple):
    """Directed inter-site link matrices over the site capacity S.

    ``bw[src, dst]`` is the bottleneck bandwidth of the src->dst path in
    bytes/s; the diagonal is the intra-site path, fast enough to make local
    reads effectively free.
    """

    bw: torch.Tensor       # f32[S, S] bytes/s
    latency: torch.Tensor  # f32[S, S] seconds

    @property
    def n_sites(self) -> int:
        return self.bw.shape[-1]


def _f32(x, device) -> torch.Tensor:
    """``jnp.asarray(x, jnp.float32)``: round float64 inputs once to f32."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)


def _finalize(bw, latency, local_bw, local_latency) -> NetworkState:
    S = bw.shape[0]
    eye = torch.eye(S, dtype=torch.bool, device=bw.device)
    bw = torch.where(eye, torch.tensor(local_bw, dtype=torch.float32, device=bw.device), bw)
    latency = torch.where(
        eye, torch.tensor(local_latency, dtype=torch.float32, device=bw.device), latency)
    return NetworkState(bw=bw, latency=latency)


def matrix_network(bw, latency, *, local_bw: float = LOCAL_BW, local_latency: float = 0.0,
                   device="cuda") -> NetworkState:
    """Explicit-topology spec: full ``[S, S]`` matrices."""
    device = resolve_device(device)
    bw, latency = _f32(bw, device), _f32(latency, device)
    if bw.shape != latency.shape or bw.dim() != 2 or bw.shape[0] != bw.shape[1]:
        raise ValueError(
            f"need square [S,S] matrices, got {tuple(bw.shape)} / {tuple(latency.shape)}")
    return _finalize(bw, latency, local_bw, local_latency)


def uniform_network(n_sites: int, *, bw: float = 1.25e9, latency: float = 0.02,
                    device="cuda") -> NetworkState:
    """Every site pair connected at the same bandwidth and latency."""
    device = resolve_device(device)
    S = n_sites
    return _finalize(torch.full((S, S), bw, dtype=torch.float32, device=device),
                     torch.full((S, S), latency, dtype=torch.float32, device=device),
                     LOCAL_BW, 0.0)


def star_network(bw_up, bw_down=None, latency=None, *, hub_latency: float = 0.0,
                 device="cuda") -> NetworkState:
    """Star topology: every transfer crosses a central hub.  src->dst
    bandwidth is ``min(bw_up[src], bw_down[dst])``; latency adds both access
    legs plus the hub."""
    device = resolve_device(device)
    bw_up = _f32(bw_up, device)
    bw_down = bw_up if bw_down is None else _f32(bw_down, device)
    S = bw_up.shape[0]
    lat = (torch.zeros((S,), dtype=torch.float32, device=device) if latency is None
           else _f32(latency, device))
    bw = torch.minimum(bw_up[:, None], bw_down[None, :])
    lat2 = lat[:, None] + lat[None, :] + float(np.float32(hub_latency))
    return _finalize(bw, lat2, LOCAL_BW, 0.0)


def tiered_network(tier, tier_bw, *, tier_latency: float = 0.01, device="cuda") -> NetworkState:
    """Tiers (WLCG T0/T1/T2): a transfer between sites of tiers (a, b)
    bottlenecks on ``tier_bw[max(a, b)]`` and pays one latency hop per tier
    level crossed up to the common root."""
    device = resolve_device(device)
    tier = torch.as_tensor(np.asarray(tier, np.int32), device=device)
    tier_bw = _f32(tier_bw, device)
    hi = torch.maximum(tier[:, None], tier[None, :])
    bw = tier_bw[hi.clamp(0, tier_bw.shape[0] - 1).long()]
    hops = (tier[:, None] + tier[None, :] + 2).float()
    return _finalize(bw, hops * float(np.float32(tier_latency)), LOCAL_BW, 0.0)


def network_from_sites(sites) -> NetworkState:
    """A star WAN from a ``SiteState``'s flat per-site links (egress
    bottleneck at the source, ingress at the destination)."""
    return star_network(sites.bw_out, sites.bw_in, sites.latency, device=sites.bw_in.device)


def with_bandwidth(net: NetworkState, bw) -> NetworkState:
    """Replace the WAN (off-diagonal) bandwidths of ``net`` with ``bw``; the
    intra-site diagonal is kept."""
    bw = _f32(bw, net.bw.device)
    if bw.shape != net.bw.shape:
        raise ValueError(f"bandwidth shape {tuple(bw.shape)} != {tuple(net.bw.shape)}")
    eye = torch.eye(net.bw.shape[-1], dtype=torch.bool, device=bw.device)
    return net._replace(bw=torch.where(eye, net.bw, bw))


def atlas_like_network(n_sites: int, *, seed: int = 0, capacity: int | None = None,
                       device="cuda") -> NetworkState:
    """WLCG-flavoured random topology matching ``atlas_like_platform``: ~10%
    Tier-1 sites on fat links, the rest on 1-10 Gbps access links, with a
    log-normal jitter per link."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cap = capacity or n_sites
    gb = 1e9 / 8
    tier = np.full(cap, 2, np.int32)
    tier[rng.choice(n_sites, size=max(1, n_sites // 10), replace=False)] = 1
    tier_bw = np.array([400.0, 100.0, 10.0]) * gb
    net = tiered_network(tier, tier_bw, tier_latency=0.015, device="cpu")
    jitter = rng.lognormal(0.0, 0.25, size=(cap, cap)).astype(np.float32)
    bw = net.bw.numpy() * jitter
    np.fill_diagonal(bw, LOCAL_BW)
    return NetworkState(bw=torch.from_numpy(bw).to(device), latency=net.latency.to(device))


# --------------------------------------------------------------------------
# flattened directed-link helpers (the transfer-queue subsystem's index space)
# --------------------------------------------------------------------------


def link_index(src, dst, n_sites: int) -> torch.Tensor:
    """Flattened directed-link id ``src * S + dst``."""
    return torch.as_tensor(src).int() * n_sites + torch.as_tensor(dst).int()


def link_caps(n_sites: int, default: int, overrides=None, device="cuda") -> torch.Tensor:
    """Per-link concurrent-transfer caps as a flat ``i32[S*S]`` vector.

    ``default`` applies to every directed link; ``overrides`` is either a
    full ``[S, S]`` matrix replacing it or a ``{(src, dst): cap}`` mapping
    patching single links (FTS-style per-channel limits)."""
    device = resolve_device(device)
    S = n_sites
    if overrides is not None and not isinstance(overrides, dict):
        caps = np.asarray(overrides, np.int32)
        if caps.shape != (S, S):
            raise ValueError(f"link cap matrix must be [{S},{S}], got {caps.shape}")
        return torch.from_numpy(caps.reshape(-1).copy()).to(device)
    caps = np.full((S, S), int(default), np.int32)
    for (src, dst), c in (overrides or {}).items():
        caps[src, dst] = int(c)
    return torch.from_numpy(caps.reshape(-1)).to(device)


# --------------------------------------------------------------------------
# per-round bandwidth sharing
# --------------------------------------------------------------------------


def link_value(mat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``mat[src, dst]`` of a link matrix ``[S, S]``; an ensemble's ``[K, S,
    S]`` is read lane by lane at ``src, dst [K, J]``."""
    if mat.dim() == 2:
        return mat[src.long(), dst.long()]
    return take(mat.flatten(-2), src.long() * mat.shape[-1] + dst.long())


def link_shares(net: NetworkState, src: torch.Tensor, dst: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """Number of concurrent ``active`` transfers on each transfer's directed
    link (>= 1 for active rows): the equal-share divisor.  One integer sum
    over the ``S * S`` links (the padding segment dropped); an ensemble's
    lanes count theirs in the same sum, lane ``l``'s link ``i`` as segment
    ``l * S * S + i``."""
    S = net.n_sites
    link = torch.where(active, src.int() * S + dst.int(), S * S)
    counts = segment_sum(active.int(), link, S * S)
    return take(counts, link.clamp(0, S * S - 1).long()).clamp_min(1).float()


def shared_transfer_times(net: NetworkState, src: torch.Tensor, dst: torch.Tensor,
                          nbytes: torch.Tensor, active: torch.Tensor):
    """Transfer duration for each row under equal-share link allocation.

    Returns ``(t, bw_eff)``: duration (0 for inactive rows) and the per-flow
    effective bandwidth; the ``bw_eff`` of the flows on one directed link sum
    to that link's capacity."""
    share = link_shares(net, src, dst, active)
    bw_eff = link_value(net.bw, src, dst) / share
    t = link_value(net.latency, src, dst) + nbytes / bw_eff.clamp_min(1e-9)
    return torch.where(active, t, 0.0), torch.where(active, bw_eff, 0.0)
