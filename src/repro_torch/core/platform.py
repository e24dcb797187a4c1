"""Platform builders.

The same generator as the JAX package's ``platform.atlas_like_platform``:
numpy's ``default_rng`` draws every column on the host, so a seed gives the
same sites bit for bit in both packages.
"""
from __future__ import annotations

import numpy as np

from .types import SiteState, make_sites


def atlas_like_platform(
    n_sites: int = 50,
    *,
    seed: int = 0,
    capacity: int | None = None,
    fail_rate: float = 0.0,
    speed_range=(5.0, 25.0),
    cores_range=(100, 2000),
    device="cuda",
) -> SiteState:
    """WLCG-flavoured heterogeneous platform (paper §4.1/§4.3: 100-2000 cores
    per site, HEPScore23-like per-core speeds, 1-100 Gbps WAN links)."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(cores_range[0], cores_range[1] + 1, size=n_sites)
    # a few Tier-1-scale sites
    tier1 = rng.choice(n_sites, size=max(1, n_sites // 10), replace=False)
    cores[tier1] = rng.integers(cores_range[1], 4 * cores_range[1], size=tier1.size)
    speed = rng.uniform(*speed_range, size=n_sites)
    gb = 1e9 / 8
    bw = rng.choice([1.0, 10.0, 40.0, 100.0], size=n_sites, p=[0.15, 0.45, 0.25, 0.15]) * gb
    return make_sites(
        cores=cores,
        speed=speed,
        memory=2.0 * cores,  # 2 GB/core, the ATLAS rule of thumb
        bw_in=bw,
        bw_out=bw,
        latency=rng.uniform(0.005, 0.12, size=n_sites),
        par_gamma=rng.uniform(0.0, 0.05, size=n_sites),
        fail_rate=np.full(n_sites, fail_rate),
        capacity=capacity,
        device=device,
    )
