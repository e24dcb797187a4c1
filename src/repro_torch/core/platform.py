"""Platform builders and the availability calendar's JSON loader.

The same generator as the JAX package's ``platform.atlas_like_platform``:
numpy's ``default_rng`` draws every column on the host, so a seed gives the
same sites bit for bit in both packages.
"""
from __future__ import annotations

import json

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


def load_availability(spec: dict | str, names=None, *, n_sites: int | None = None,
                      device="cuda"):
    """Build an ``AvailabilityState`` from a CGSim-style JSON payload.

    spec: {"windows": [{"site": <name or index>, "start": s, "end": s,
                        "factor"?: 0.0, "preempt"?: false}, ...]}
    Site names resolve through ``names``; ``n_sites`` defaults to
    ``len(names)``.
    """
    from .availability import make_availability

    if isinstance(spec, str):
        spec = json.loads(spec)
    if n_sites is None:
        if names is None:
            raise ValueError("load_availability needs names= or n_sites=")
        n_sites = len(names)
    index = {nm: i for i, nm in enumerate(names or [])}
    windows = []
    for w in spec.get("windows", []):
        site = w["site"]
        if isinstance(site, str):
            if site not in index:
                raise ValueError(f"unknown site name {site!r}")
            site = index[site]
        windows.append(
            dict(site=site, start=w["start"], end=w["end"],
                 factor=w.get("factor", 0.0), preempt=w.get("preempt", False))
        )
    return make_availability(n_sites, windows, device=device)
