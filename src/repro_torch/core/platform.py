"""Platform construction: CGSim's JSON input layer and the WLCG-like builder.

The paper configures a simulation from three JSON files (infrastructure,
network topology, execution parameters); ``load_platform`` takes the same
three payloads and ``dump_platform`` writes the infrastructure back.
``load_availability`` and ``load_faults`` read the availability calendar
and the fault scenario, resolving site names through ``load_platform``'s
name list; ``apply_site_params`` overlays calibration's per-site knobs.  ``atlas_like_platform`` is the JAX package's generator: numpy's
``default_rng`` draws every column on the host, so a seed gives the same
sites bit for bit in both packages.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from .types import SiteState, make_sites


class ExecutionParams(NamedTuple):
    max_rounds: int = 200_000
    horizon: float = float("inf")
    max_retries: int = 3
    log_rows: int = 0
    monitor_every: int = 1
    policy: str = "panda_dispatch"
    seed: int = 0


def load_platform(infrastructure: dict | str, network: dict | str | None = None,
                  execution: dict | str | None = None, capacity: int | None = None,
                  device="cuda"):
    """Build ``(SiteState, names, ExecutionParams)`` from CGSim-style JSON.

    infrastructure: {"sites": [{"name", "cores", "speed", "memory_gb",
                                "fail_rate"?, "par_gamma"?}, ...]}
    network:        {"links": [{"site", "bw_in_gbps", "bw_out_gbps",
                                "latency_ms"}, ...]}  (defaults if omitted)
    execution:      {"max_rounds"?, "horizon"?, "max_retries"?, "policy"?, ...}
    """
    if isinstance(infrastructure, str):
        infrastructure = json.loads(infrastructure)
    if isinstance(network, str):
        network = json.loads(network)
    if isinstance(execution, str):
        execution = json.loads(execution)

    sites_cfg = infrastructure["sites"]
    names = [s.get("name", f"site{i}") for i, s in enumerate(sites_cfg)]
    link_by_site = {link["site"]: link for link in (network or {}).get("links", [])}

    def get_link(name, key, default):
        return link_by_site.get(name, {}).get(key, default)

    gb = 1e9 / 8  # Gbps -> bytes/s
    sites = make_sites(
        cores=[s["cores"] for s in sites_cfg],
        speed=[s.get("speed", 10.0) for s in sites_cfg],
        memory=[s.get("memory_gb", 2.0 * s["cores"]) for s in sites_cfg],
        bw_in=[get_link(nm, "bw_in_gbps", 10.0) * gb for nm in names],
        bw_out=[get_link(nm, "bw_out_gbps", 10.0) * gb for nm in names],
        latency=[get_link(nm, "latency_ms", 10.0) / 1e3 for nm in names],
        par_gamma=[s.get("par_gamma", 0.02) for s in sites_cfg],
        fail_rate=[s.get("fail_rate", 0.0) for s in sites_cfg],
        capacity=capacity,
        device=device,
    )
    return sites, names, ExecutionParams(**(execution or {}))


def dump_platform(sites: SiteState, names=None) -> str:
    """A SiteState back as the CGSim infrastructure JSON."""
    cols = {k: getattr(sites, k).cpu().numpy() for k in
            ("active", "cores", "speed", "memory", "par_gamma", "fail_rate")}
    rows = []
    for i in range(int(cols["active"].sum())):
        rows.append(
            dict(
                name=(names[i] if names else f"site{i}"),
                cores=int(cols["cores"][i]),
                speed=float(cols["speed"][i]),
                memory_gb=float(cols["memory"][i]),
                par_gamma=float(cols["par_gamma"][i]),
                fail_rate=float(cols["fail_rate"][i]),
            )
        )
    return json.dumps({"sites": rows}, indent=2)


def deactivate_sites(sites: SiteState, down) -> SiteState:
    """Mark sites inactive: jobs there keep running, nothing new is assigned
    (the dispatcher's feasibility mask reads ``active``)."""
    down = torch.as_tensor(down, device=sites.active.device)
    return sites._replace(active=sites.active & ~down)


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


def apply_site_params(sites: SiteState, *, speed=None, latency=None) -> SiteState:
    """Overlay continuous per-site knobs on a platform (calibration's hot
    path).  ``None`` leaves a knob as it is; values broadcast against the
    site axis (a candidate population passes ``[K, S]``)."""
    repl = {}
    if speed is not None:
        repl["speed"] = torch.as_tensor(speed, dtype=torch.float32, device=sites.speed.device)
    if latency is not None:
        repl["latency"] = torch.as_tensor(latency, dtype=torch.float32,
                                          device=sites.latency.device)
    return sites._replace(**repl) if repl else sites


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


def load_faults(spec: dict | str, names=None, *, n_sites: int | None = None,
                job_capacity=None, device="cuda"):
    """Build a ``FaultState`` from a CGSim-style JSON payload.

    spec: {"link_fail_p"?: {"default": p, "links": [{"src": <name or idx>,
                                                     "dst": ..., "p": p}]},
           "xfer_backoff"?: s, "max_xfer_attempts"?: n,
           "job_backoff"?: s, "walltime"?: s,
           "replica_loss"?: [{"t": s, "dataset": d, "site": <name or idx>}],
           "blacklist"?: {"threshold": x, "alpha"?: a, "cooldown"?: s}}

    Site names resolve through ``names`` (the ``load_platform`` name list);
    ``n_sites`` defaults to ``len(names)``.  ``job_capacity`` must match the
    run's ``JobsState`` (it also takes the state itself).
    """
    from .faults import make_faults

    if isinstance(spec, str):
        spec = json.loads(spec)
    if n_sites is None:
        if names is None:
            raise ValueError("load_faults needs names= or n_sites=")
        n_sites = len(names)
    if job_capacity is None:
        raise ValueError("load_faults needs job_capacity= (int or JobsState)")
    index = {nm: i for i, nm in enumerate(names or [])}

    def site_idx(site):
        if isinstance(site, str):
            if site not in index:
                raise ValueError(f"unknown site name {site!r}")
            return index[site]
        return int(site)

    kw = {}
    lf = spec.get("link_fail_p")
    if lf is not None:
        if isinstance(lf, dict):
            mat = np.full((n_sites, n_sites), float(lf.get("default", 0.0)), np.float32)
            for link in lf.get("links", []):
                mat[site_idx(link["src"]), site_idx(link["dst"])] = float(link["p"])
            kw["link_fail_p"] = mat
        else:
            kw["link_fail_p"] = float(lf)
    for key in ("xfer_backoff", "max_xfer_attempts", "job_backoff", "walltime"):
        if key in spec:
            kw[key] = spec[key]
    if "replica_loss" in spec:
        kw["replica_loss"] = [
            (float(ev["t"]), int(ev["dataset"]), site_idx(ev["site"]))
            for ev in spec["replica_loss"]
        ]
    bl = spec.get("blacklist")
    if bl is not None:
        kw["blacklist_threshold"] = float(bl["threshold"])
        if "alpha" in bl:
            kw["blacklist_alpha"] = float(bl["alpha"])
        if "cooldown" in bl:
            kw["blacklist_cooldown"] = float(bl["cooldown"])
    return make_faults(n_sites, job_capacity, device=device, **kw)
