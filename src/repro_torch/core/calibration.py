"""Calibration (paper §4.2, Fig. 1c, Fig. 3) on PyTorch.

The paper replays historical PanDA jobs at their real sites and tunes per-site
CPU speed to minimise ``sim_exe_time - his_exe_time``, comparing four
optimizers: brute force, random sampling, Bayesian optimisation and CMA-ES.
All four are here (``calibrate``), over two objectives that agree in pinned
replay: ``closed_form_walltimes`` (the service-time model evaluated directly)
and ``engine_objective`` (the full engine under a pinned-assignment policy).

``calibrate_platform`` fits the wider knob set (per-site speeds, the WAN
bandwidth matrix, per-site startup overheads) to a recorded trace, with
SPSA and CMA-ES over a candidate population that runs as the lanes of one
``simulate_many`` call (``make_population_objective``), or with Adam on
``torch.autograd`` of the closed form (``method="grad"``).

Everything runs on the device of the problem's tensors: build a problem with
``device="cpu"`` (or carry one across with ``convert``) to run on the CPU.
The JAX package's scanned loops are Python loops here, with at most one
device-to-host read an iteration.  Float orders follow the JAX package's
compiled programs: the closed form shares the engine's ``compute_time``
(its FMA), ``exp``/``log`` are XLA:CPU's (``scan.exp_f32``/``log_f32``),
sums and segment sums add in XLA's order, and every clip a gradient passes
through is ``minimum(maximum(x, lo), hi)``, whose gradient at a bound is 0.5
as JAX's ``clip`` gives.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import rng as _rng
from .engine import _tree_map, compute_time, simulate
from .policies import make_policy
from .scan import exp_f32, fma_f32, log_f32, segment_sum_f32, sqrt_f32, sum_f32
from .types import DONE, JobsState, SiteState, take

INF = float("inf")

# --------------------------------------------------------------------------
# ground truth + objective
# --------------------------------------------------------------------------


def _device(problem) -> torch.device:
    return problem.jobs.arrival.device


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, gradient 0.5 at a bound."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _lanes_of(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A job-indexed ``idx [J]`` broadcast over the candidate lanes of a site
    table ``[K, S]`` (unchanged without lanes), for ``types.take``."""
    return idx.expand(table.shape[:-1] + idx.shape) if table.dim() > idx.dim() else idx


def closed_form_walltimes(jobs: JobsState, sites: SiteState, site: torch.Tensor) -> torch.Tensor:
    """Walltime of each job if executed at ``site`` (no queueing, unit
    bandwidth share): ``engine.service_time`` at share 1, in its float order.
    Sites may carry a leading candidate axis (``speed [K, S]``); the result is
    then ``[K, J]``."""
    s = site.clamp(0, sites.capacity - 1).long()
    s = _lanes_of(s, sites.speed)
    return (
        take(sites.latency, s) + jobs.bytes_in / take(sites.bw_in, s)
        + compute_time(jobs, sites, s)
        + jobs.bytes_out / take(sites.bw_out, s)
    )


def per_site_rel_mae(jobs: JobsState, hist_site, hist_wall, sim_wall, n_sites: int):
    """Relative MAE per (site, job class), Fig. 3's metric: ``(f32[S, 2],
    bool[S, 2])``, column 0 single-core, 1 multicore; cells with no jobs are
    0 and masked off.  ``sim_wall [K, J]`` gives ``[K, S, 2]``."""
    rel = (sim_wall - hist_wall).abs() / hist_wall.clamp_min(1e-9)
    multi = jobs.cores > 1
    seg = _lanes_of(torch.where(jobs.valid, hist_site, n_sites), rel)

    def cls_mae(mask):
        num = segment_sum_f32(torch.where(mask, rel, 0.0), seg, n_sites + 1)[..., :n_sites]
        den = segment_sum_f32(_lanes_of(mask.float(), rel).contiguous(), seg,
                              n_sites + 1)[..., :n_sites]
        return num / den.clamp_min(1.0), den > 0

    mae_s, has_s = cls_mae(jobs.valid & ~multi)
    mae_m, has_m = cls_mae(jobs.valid & multi)
    return torch.stack([mae_s, mae_m], -1), torch.stack([has_s, has_m], -1)


def _sum_cells(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of ``[..., S, C]`` over its last two axes in XLA:CPU's
    form: a reduce-window of 32 rows (the padding split as ``sum_f32``
    splits it), each window's cells added row-major from 0, then the window
    sums.  Exact on most shapes tried; a few differ in the last bit."""
    *lead, S, C = x.shape
    W = 1
    if S > 32:
        pad = -S % 32
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        W = (S + pad) // 32
    flat = x.reshape(-1)
    n = flat.shape[0] // (math.prod(lead) * W)
    seg = torch.arange(flat.shape[0], device=x.device) // n
    sums = segment_sum_f32(flat, seg, flat.shape[0] // n).view(*lead, W)
    return sum_f32(sums, -1) if W > 1 else sums[..., 0]


def geomean_error(mae: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """Geometric mean of per-(site, class) relative MAE over populated cells."""
    logs = torch.where(has, log_f32(torch.maximum(mae, mae.new_tensor(1e-9))), 0.0)
    n = has.sum((-2, -1)).clamp_min(1)
    return exp_f32(_sum_cells(logs) / n)


class CalibProblem(NamedTuple):
    jobs: JobsState
    sites0: SiteState         # platform with the *misconfigured* initial speeds
    hist_site: torch.Tensor   # i32[J] historical assignment (PanDA replay)
    hist_wall: torch.Tensor   # f32[J] ground-truth walltime
    n_sites: int


def make_synthetic_problem(jobs: JobsState, sites: SiteState, *, seed: int = 0,
                           misconfig_sigma: float = 0.75,
                           noise_sigma: float = 0.15) -> CalibProblem:
    """A Fig.-3-style problem: hidden true speeds produce the "historical"
    walltimes (log-normal measurement noise), then the platform is
    misconfigured by ``misconfig_sigma`` in log space.  The draws are the JAX
    package's key stream (``rng``); on the device of ``sites``."""
    dev = sites.speed.device
    k1, k2, k3 = _rng.split(_rng.PRNGKey(seed, dev), 3)
    S = sites.capacity
    w = torch.where(sites.active, sites.cores.float(), 0.0)
    logits = log_f32(w.clamp_min(1e-9))
    hist_site = _rng.categorical(k1, logits[None, :].expand(jobs.capacity, S)).int()
    wall = closed_form_walltimes(jobs, sites, hist_site)
    wall = wall * exp_f32(noise_sigma * _rng.normal(k2, tuple(wall.shape)))
    bad_speed = sites.speed * exp_f32(misconfig_sigma * _rng.normal(k3, (S,)))
    return CalibProblem(jobs=jobs, sites0=sites._replace(speed=bad_speed),
                        hist_site=hist_site, hist_wall=wall, n_sites=S)


def closed_form_objective(problem: CalibProblem, speeds: torch.Tensor):
    """``(err [S, 2], has [S, 2], geomean)`` for one speed vector, or for a
    batch ``speeds [K, S]`` (leading K on every output)."""
    sites = problem.sites0._replace(speed=speeds)
    sim_wall = closed_form_walltimes(problem.jobs, sites, problem.hist_site)
    mae, has = per_site_rel_mae(problem.jobs, problem.hist_site, problem.hist_wall, sim_wall,
                                problem.sites0.capacity)
    return mae, has, geomean_error(mae, has)


def pinned_policy(hist_site: torch.Tensor):
    """Replay policy: every job scores +1 only at its historical site (one
    ``[J, S]`` score, shared by every lane of an ensemble)."""

    def score(jobs, sites, state, clock, rng):
        iota = torch.arange(sites.capacity, device=hist_site.device)
        return (iota == hist_site[:, None]).float()

    return make_policy("pinned_replay", score)


def _walltimes_done(jobs: JobsState) -> torch.Tensor:
    return torch.where(jobs.state == DONE, jobs.t_finish - jobs.t_start, 0.0)


def engine_objective(problem: CalibProblem, speeds: torch.Tensor, *, max_rounds: int = 60_000):
    """Full-engine objective (queueing included): ``(err, has, geomean)`` of
    the pinned replay at ``speeds``."""
    sites = problem.sites0._replace(speed=speeds)
    dev = _device(problem)
    res = simulate(problem.jobs, sites, pinned_policy(problem.hist_site),
                   _rng.PRNGKey(0, dev), max_rounds=max_rounds, device=dev)
    mae, has = per_site_rel_mae(problem.jobs, problem.hist_site, problem.hist_wall,
                                _walltimes_done(res.jobs), problem.sites0.capacity)
    return mae, has, geomean_error(mae, has)


# --------------------------------------------------------------------------
# optimizers 1/2: brute-force grid + random search (the paper's winner)
# --------------------------------------------------------------------------


class CalibResult(NamedTuple):
    speeds: torch.Tensor     # f32[S] calibrated speeds
    err0: torch.Tensor       # geomean error before
    err: torch.Tensor        # geomean error after
    history: torch.Tensor    # f32[iters] best-so-far geomean per iteration


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` as XLA compiles it: ``start * (1 - s) + stop * s``
    with ``s = i * f32(1 / (num - 1))`` (the division folded to a
    reciprocal), then ``stop`` itself."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * \
        torch.tensor(1.0 / div, dtype=torch.float32)
    body = start * (1.0 - step) + stop * step
    return torch.cat([body, torch.full((1,), stop, dtype=torch.float32, device=device)])


def grid_search(problem: CalibProblem, *, n_points: int = 64,
                log_range: float = 2.0) -> CalibResult:
    """Brute force, feasible because the walltime objective decomposes per
    site: sweep a per-site 1-D grid of multipliers in log space and take each
    site's argmin.  Every grid point is one lane of one batched objective."""
    speed0 = problem.sites0.speed
    _, _, err0 = closed_form_objective(problem, speed0)
    grid = exp_f32(_linspace(-log_range, log_range, n_points, speed0.device))
    mae, has, _ = closed_form_objective(problem, speed0[None, :] * grid[:, None])
    errs = torch.where(has, mae, INF).mean(-1)                   # [n_points, S]
    best = errs.argmin(0)
    speeds = speed0 * grid[best]
    _, _, err = closed_form_objective(problem, speeds)
    hist = torch.cummin(errs.amin(1), 0).values
    return CalibResult(speeds=speeds, err0=err0, err=err, history=hist)


def random_search(problem: CalibProblem, rng: torch.Tensor, *, n_iters: int = 30,
                  pop: int = 32, sigma0: float = 0.8, shrink: float = 0.88,
                  per_site: bool = True) -> CalibResult:
    """Log-normal random search around the incumbent with a shrinking step.
    ``per_site=True`` (beyond the paper): each site adopts the candidate that
    minimises *its own* error, valid because the objective is separable."""
    speed0 = problem.sites0.speed
    S = speed0.shape[0]
    _, _, err0 = closed_form_objective(problem, speed0)
    speeds = speed0
    sigma = torch.tensor(sigma0, dtype=torch.float32, device=speed0.device)
    hist = []
    for key in _rng.split(rng.to(speed0.device), n_iters):
        noise = _rng.normal(key, (pop, S))
        cands = torch.cat([speeds[None, :], speeds[None, :] * exp_f32(sigma * noise)])
        mae, has, ges = closed_form_objective(problem, cands)
        site_err = torch.where(has, mae, 0.0).sum(-1) / has.sum(-1).clamp_min(1)
        site_err = torch.where(has.any(-1), site_err, INF)
        if per_site:
            speeds = cands[site_err.argmin(0), torch.arange(S, device=speeds.device)]
        else:
            speeds = cands[ges.argmin()]
        sigma = sigma * shrink
        hist.append(closed_form_objective(problem, speeds)[2])
    _, _, err = closed_form_objective(problem, speeds)
    return CalibResult(speeds=speeds, err0=err0, err=err,
                       history=torch.cummin(torch.stack(hist), 0).values)


# --------------------------------------------------------------------------
# optimizer 3: CMA-ES (Hansen 2016), in log-speed space
# --------------------------------------------------------------------------


def _cma_weights(n: int, lam: int, device):
    """CMA-ES's recombination weights and learning rates for dimension ``n``
    and population ``lam`` (float32, as the JAX package computes them)."""
    mu = lam // 2
    f32 = dict(dtype=torch.float32, device=device)
    w = log_f32(torch.tensor(mu + 0.5, **f32)) - log_f32(torch.arange(1, mu + 1, **f32))
    w = w / sum_f32(w)
    mueff = 1.0 / sum_f32(w ** 2)
    cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
    cs = (mueff + 2) / (n + mueff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mueff)
    cmu = torch.minimum(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
    damps = 1 + 2 * torch.clamp_min(sqrt_f32((mueff - 1) / (n + 1)) - 1, 0.0) + cs
    chi_n = sqrt_f32(torch.tensor(float(n), **f32)) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
    return mu, w, mueff, cc, cs, c1, cmu, damps, chi_n


def _cma_update(m, sigma, C, pc, ps, y, f, evecs, Dd, consts):
    """One generation's update from the displacements ``y [lam, n]`` and
    their losses ``f``: the mean, both evolution paths, the covariance and
    the step size."""
    mu, w, mueff, cc, cs, c1, cmu, damps, chi_n = consts
    n = m.shape[0]
    idx = torch.argsort(f, stable=True)[:mu]
    y_sel = y[idx]
    y_w = (w[:, None] * y_sel).sum(0)
    m = m + sigma * y_w
    c_inv_sqrt = evecs @ torch.diag(1.0 / Dd) @ evecs.T
    ps = (1 - cs) * ps + sqrt_f32(cs * (2 - cs) * mueff) * (c_inv_sqrt @ y_w)
    hsig = (torch.linalg.norm(ps) / sqrt_f32(1 - (1 - cs) ** 2) / chi_n) < (1.4 + 2 / (n + 1))
    pc = (1 - cc) * pc + hsig * sqrt_f32(cc * (2 - cc) * mueff) * y_w
    C = ((1 - c1 - cmu) * C
         + c1 * (torch.outer(pc, pc) + (~hsig).float() * cc * (2 - cc) * C)
         + cmu * (w[:, None, None] * (y_sel[:, :, None] * y_sel[:, None, :])).sum(0))
    sigma = sigma * exp_f32((cs / damps) * (torch.linalg.norm(ps) / chi_n - 1))
    return m, sigma, C, pc, ps


def _cma_sample(C, key, lam):
    """Eigendecomposition of ``C`` and ``lam`` displacements ``(z * D) @ B.T``."""
    n = C.shape[0]
    evals, evecs = torch.linalg.eigh(C + 1e-10 * torch.eye(n, device=C.device))
    Dd = sqrt_f32(torch.clamp_min(evals, 1e-12))
    z = _rng.normal(key, (lam, n))
    return (z * Dd[None, :]) @ evecs.T, evecs, Dd


def cma_es(problem: CalibProblem, rng: torch.Tensor, *, n_iters: int = 60, pop: int = 0,
           sigma0: float = 0.5) -> CalibResult:
    """CMA-ES over log-speeds; each generation is one batched objective."""
    speed0 = problem.sites0.speed
    dev = speed0.device
    n = speed0.shape[0]
    lam = max(pop or int(4 + 3 * math.log(n)), 8)
    consts = _cma_weights(n, lam, dev)
    _, _, err0 = closed_form_objective(problem, speed0)
    m, sigma = log_f32(speed0), torch.tensor(sigma0, dtype=torch.float32, device=dev)
    C, pc, ps = torch.eye(n, device=dev), torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    hist = []
    for key in _rng.split(rng.to(dev), n_iters):
        y, evecs, Dd = _cma_sample(C, key, lam)
        fx = closed_form_objective(problem, exp_f32(m[None, :] + sigma * y))[2]
        m, sigma, C, pc, ps = _cma_update(m, sigma, C, pc, ps, y, fx, evecs, Dd, consts)
        hist.append(fx.amin())
    speeds = exp_f32(m)
    _, _, err = closed_form_objective(problem, speeds)
    return CalibResult(speeds=speeds, err0=err0, err=err,
                       history=torch.cummin(torch.stack(hist), 0).values)


# --------------------------------------------------------------------------
# optimizer 4: GP-UCB Bayesian optimization (exact GP on a fixed buffer)
# --------------------------------------------------------------------------


def gp_bo(problem: CalibProblem, rng: torch.Tensor, *, n_iters: int = 48, n_init: int = 16,
          n_cand: int = 256, lengthscale: float = 1.0, beta: float = 2.0) -> CalibResult:
    """GP-UCB over log-speeds: an exact GP (Cholesky) on a fixed-size buffer,
    the paper's BO baseline at the scale its experiments used."""
    speed0 = problem.sites0.speed
    dev = speed0.device
    S = speed0.shape[0]
    T = n_init + n_iters
    m0 = log_f32(speed0)
    _, _, err0 = closed_form_objective(problem, speed0)

    def f(logsp):
        return closed_form_objective(problem, exp_f32(logsp))[2]

    def kern(a, b):
        d2 = sum_f32((a[:, None, :] - b[None, :, :]) ** 2, -1)
        return exp_f32(-0.5 * d2 / lengthscale ** 2)

    k_init, k_loop = _rng.split(rng.to(dev))
    X0 = m0[None, :] + 0.6 * _rng.normal(k_init, (n_init, S))
    X = torch.zeros((T, S), device=dev)
    X[:n_init] = X0
    y = torch.full((T,), 1e6, device=dev)
    y[:n_init] = f(X0)
    iota = torch.arange(T, device=dev)
    hist = []
    for t, key in enumerate(_rng.split(k_loop, n_iters), start=n_init):
        mask = iota < t
        ymu = sum_f32(torch.where(mask, y, 0.0)) / mask.sum().clamp_min(1)
        yc = torch.where(mask, y - ymu, 0.0)
        K = kern(X, X) * (mask[:, None] & mask[None, :]) + torch.eye(T, device=dev) * (
            1e-4 + (~mask) * 1e6)
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
        best_idx = torch.where(mask, y, INF).argmin()
        kc, ks = _rng.split(key)
        scale = _rng.uniform(ks, (n_cand, 1), minval=0.05, maxval=0.8)
        cand = X[best_idx][None, :] + scale * _rng.normal(kc, (n_cand, S))
        Kc = kern(cand, X) * mask[None, :]
        mu = Kc @ alpha + ymu
        v = torch.linalg.solve_triangular(L, Kc.T, upper=False)
        var = torch.clamp_min(1.0 - sum_f32(v ** 2, 0), 1e-9)
        x_new = cand[(mu - beta * sqrt_f32(var)).argmin()]
        y_new = f(x_new)
        hist.append(torch.minimum(y_new, torch.where(mask, y, INF).amin()))
        X[t] = x_new
        y[t] = y_new
    speeds = exp_f32(X[y.argmin()])
    _, _, err = closed_form_objective(problem, speeds)
    return CalibResult(speeds=speeds, err0=err0, err=err,
                       history=torch.cummin(torch.stack(hist), 0).values)


OPTIMIZERS: dict[str, Callable] = {
    "grid": grid_search,
    "random": random_search,
    "cma_es": cma_es,
    "gp_bo": gp_bo,
}


def calibrate(problem: CalibProblem, method: str = "random", seed: int = 0,
              **kw) -> CalibResult:
    if method == "grid":
        return grid_search(problem, **kw)
    return OPTIMIZERS[method](problem, _rng.PRNGKey(seed, _device(problem)), **kw)


# ==========================================================================
# platform calibration: the continuous knob set (per-site speeds, the WAN
# bandwidth matrix, per-site startup overheads) as one flat vector, scored
# against a recorded trace with the candidate population in ensemble lanes
# ==========================================================================


PARAM_FIELDS = ("speed", "bw", "overhead")
_EPS = 1e-12


class PlatformParams(NamedTuple):
    """Continuous platform knobs.  ``None`` fields are out of the search
    (``ravel_params`` drops them and ``unravel`` restores them).  The ``bw``
    diagonal (intra-site LAN) is inert: ``apply_platform_params`` keeps the
    platform's own diagonal."""

    speed: torch.Tensor | None = None     # f32[S]   per-site CPU speed
    bw: torch.Tensor | None = None        # f32[S,S] WAN bandwidth, bytes/s
    overhead: torch.Tensor | None = None  # f32[S]   per-site startup overhead, s


class PlatformBounds(NamedTuple):
    """Box bounds (the same fields as the params) for the log-space search."""

    lo: PlatformParams
    hi: PlatformParams


def default_bounds(params: PlatformParams, *, factor: float = 30.0) -> PlatformBounds:
    """Multiplicative box around the starting point: ``[p/factor, p*factor]``."""
    return PlatformBounds(lo=_tree_map(lambda x: x / factor, params),
                          hi=_tree_map(lambda x: x * factor, params))


def encode_params(params: PlatformParams, bounds: PlatformBounds) -> PlatformParams:
    """Params -> log space, clipped into the box first."""
    return _tree_map(
        lambda p, lo, hi: log_f32(_clip(p, lo.clamp_min(_EPS), hi.clamp_min(_EPS))),
        params, bounds.lo, bounds.hi)


def decode_params(z: PlatformParams, bounds: PlatformBounds) -> PlatformParams:
    """Log space -> params.  The clip guarantees every decoded candidate,
    hence every ``calibrate_platform`` result, lies inside the bounds."""
    return _tree_map(lambda z_, lo, hi: _clip(exp_f32(z_), lo, hi), z, bounds.lo, bounds.hi)


class PlatformProblem(NamedTuple):
    """Trace-matching problem over the platform knob set.

    ``hist_src[j]`` is the replica source of job ``j``'s stage-in (-1: a
    flat-link stage-in, no WAN hop) and ``hist_bytes[j]`` the bytes it moved
    (0 for local replica reads).  ``hist_wall[j] <= 0`` marks jobs the trace
    did not cover; they drop out of the mape and quantile losses.
    ``data_policy``/``replicas``/``availability`` describe the scenario for
    the engine objective; the closed form ignores them."""

    jobs: JobsState
    sites0: SiteState               # platform at the *misconfigured* start
    network0: object = None         # NetworkState | None
    hist_site: torch.Tensor = None  # i32[J]
    hist_wall: torch.Tensor = None  # f32[J]
    hist_src: torch.Tensor = None   # i32[J] | None
    hist_bytes: torch.Tensor = None  # f32[J] | None
    data_policy: object = None
    replicas: object = None
    availability: object = None

    @property
    def n_sites(self) -> int:
        return self.sites0.capacity


def platform_params(problem: PlatformProblem, include=PARAM_FIELDS) -> PlatformParams:
    """The problem's starting point as params (``None`` = excluded)."""
    return PlatformParams(
        speed=problem.sites0.speed if "speed" in include else None,
        bw=problem.network0.bw if "bw" in include and problem.network0 is not None else None,
        overhead=problem.sites0.latency if "overhead" in include else None,
    )


def _with_bandwidth(net, bw: torch.Tensor):
    """``network.with_bandwidth`` that also takes a candidate batch ``bw [K,
    S, S]`` (the network's fields then broadcast to K)."""
    from .network import with_bandwidth

    if bw.dim() == net.bw.dim():
        return with_bandwidth(net, bw)
    K = bw.shape[0]
    eye = torch.eye(net.bw.shape[-1], dtype=torch.bool, device=bw.device)
    return net._replace(bw=torch.where(eye, net.bw, bw),
                        latency=net.latency.expand(K, *net.latency.shape))


def apply_platform_params(problem: PlatformProblem, params: PlatformParams):
    """Materialise one candidate (or a batch with a leading K) as
    ``(SiteState, NetworkState | None)``."""
    from .platform import apply_site_params

    sites = apply_site_params(problem.sites0, speed=params.speed, latency=params.overhead)
    net = problem.network0
    if params.bw is not None:
        if net is None:
            raise ValueError("bw params need a problem.network0 topology")
        net = _with_bandwidth(net, params.bw)
    return sites, net


def platform_walltimes(problem: PlatformProblem, params: PlatformParams) -> torch.Tensor:
    """Differentiable closed-form walltime under one candidate (or a batch).

    Mirrors the engine's data pricing at unit link share: jobs with a WAN
    stage-in (``hist_src >= 0``) swap the flat latency + stage-in terms for
    the recorded transfer (latency plus bytes over the candidate's ``bw[src,
    dst]``, nothing for local replica reads)."""
    sites, net = apply_platform_params(problem, params)
    wall = closed_form_walltimes(problem.jobs, sites, problem.hist_site)
    if net is None or problem.hist_src is None:
        return wall
    S = problem.sites0.capacity
    s = problem.hist_site.clamp(0, S - 1).long()
    src = problem.hist_src.clamp(0, S - 1).long()
    has_ds = problem.hist_src >= 0
    nbytes = problem.hist_bytes if problem.hist_bytes is not None else problem.jobs.bytes_in
    s_k = _lanes_of(s, sites.latency)
    in_flat = take(sites.latency, s_k) + problem.jobs.bytes_in / take(sites.bw_in, s_k)
    xfer = has_ds & (nbytes > 0) & (src != s)
    link = _lanes_of(src * S + s, net.bw.flatten(-2))
    bw = take(net.bw.flatten(-2), link)
    t_net = torch.where(xfer, take(net.latency.flatten(-2), link)
                        + nbytes / torch.maximum(bw, bw.new_tensor(_EPS)), 0.0)
    return torch.where(has_ds, wall - in_flat + t_net, wall)


# --------------------------------------------------------------------------
# trace losses
# --------------------------------------------------------------------------

# jnp.linspace(0.1, 0.9, 9)'s float32 values
_QUANTILES = (0.10000000149011612, 0.20000000298023224, 0.30000001192092896,
              0.3999999761581421, 0.5, 0.5999999642372131, 0.699999988079071,
              0.7999999523162842, 0.8999999761581421)
TRACE_LOSSES = ("mape", "quantile", "geomean")


class _Fma(torch.autograd.Function):
    """``scan.fma_f32`` (one rounding of ``a * b + c``) with its gradient."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def _nanquantile(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(a, q)`` (linear) along the last axis: ``[..., Q]``.
    NaNs sort last; the blend of the two order statistics is one FMA."""
    a = torch.sort(a, -1).values
    counts = (~torch.isnan(a)).sum(-1, keepdim=True).float()
    qq = q * (counts - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1 - hw
    low = torch.clamp_min(torch.minimum(low, counts - 1), 0).long()
    high = torch.clamp_min(torch.minimum(high, counts - 1), 0).long()
    lo_v, hi_v = a.gather(-1, low), a.gather(-1, high)
    return _Fma.apply(hi_v, hw, lo_v * lw)


def trace_loss(sim_wall, hist_wall, mask, *, loss: str = "mape") -> torch.Tensor:
    """Scalar distance between simulated and recorded walltimes (a leading
    candidate axis on ``sim_wall`` gives one per candidate).

    ``mape``: mean |sim - hist| / hist over covered jobs.  ``quantile``: the
    mean relative gap between the walltime deciles, distribution matching
    that tolerates per-job noise."""
    if loss == "mape":
        rel = (sim_wall - hist_wall).abs() / hist_wall.clamp_min(1e-9)
        return sum_f32(torch.where(mask, rel, 0.0), -1) / mask.sum(-1).clamp_min(1)
    if loss == "quantile":
        q = torch.tensor(_QUANTILES, dtype=torch.float32, device=sim_wall.device)
        q_sim = _nanquantile(torch.where(mask, sim_wall, float("nan")), q)
        q_his = _nanquantile(torch.where(mask, hist_wall, float("nan")), q)
        gap = (q_sim - q_his).abs() / q_his.clamp_min(1e-9)
        return sum_f32(gap, -1) / len(_QUANTILES)
    raise ValueError(f"unknown loss {loss!r}; have {TRACE_LOSSES}")


def _score_walltimes(problem: PlatformProblem, sim_wall, loss: str) -> torch.Tensor:
    if loss == "geomean":
        mae, has = per_site_rel_mae(problem.jobs, problem.hist_site, problem.hist_wall,
                                    sim_wall, problem.sites0.capacity)
        return geomean_error(mae, has)
    mask = problem.jobs.valid & (problem.hist_wall > 0)
    return trace_loss(sim_wall, problem.hist_wall, mask, loss=loss)


def platform_objective(problem: PlatformProblem, params: PlatformParams, *,
                       loss: str = "mape") -> torch.Tensor:
    """Closed-form scalar loss for one candidate, differentiable in every
    ``PlatformParams`` field: the ``torch.autograd`` path of
    ``calibrate_platform``."""
    return _score_walltimes(problem, platform_walltimes(problem, params), loss)


def _engine_score(problem: PlatformProblem, jobs: JobsState, loss: str) -> torch.Tensor:
    """Loss of finished engine lanes plus a penalty for work they never ran
    (a candidate so slow the round budget ran out must not look accurate
    because its unfinished jobs fell out of the metric)."""
    done = jobs.state == DONE
    base = _score_walltimes(problem, _walltimes_done(jobs), loss)
    undone = (problem.jobs.valid & ~done).sum(-1).float()
    return base + 10.0 * undone / problem.jobs.valid.sum().clamp_min(1)


def _problem_sim_kwargs(problem: PlatformProblem, net) -> dict:
    kw = {}
    if problem.data_policy is not None:
        kw.update(data_policy=problem.data_policy, network=net, replicas=problem.replicas)
    if problem.availability is not None:
        kw["availability"] = problem.availability
    return kw


def engine_platform_objective(problem: PlatformProblem, params: PlatformParams,
                              rng: torch.Tensor | None = None, *, loss: str = "mape",
                              max_rounds: int = 20_000, policy=None) -> torch.Tensor:
    """Exact-engine scalar loss for one candidate (queueing, WAN sharing,
    subsystems): the solo form the population objective is held against.
    Pass a pre-built ``policy`` to reuse one across a loop of calls."""
    dev = _device(problem)
    sites, net = apply_platform_params(problem, params)
    rng = _rng.PRNGKey(0, dev) if rng is None else rng
    policy = pinned_policy(problem.hist_site) if policy is None else policy
    res = simulate(problem.jobs, sites, policy, rng, max_rounds=max_rounds, device=dev,
                   **_problem_sim_kwargs(problem, net))
    return _engine_score(problem, res.jobs, loss)


def ravel_params(params: PlatformParams):
    """Flatten params to ``(f32[D], unravel)`` in ``ravel_pytree``'s order
    (``speed``, ``bw`` row-major, ``overhead``; ``None`` fields dropped and
    restored by ``unravel``).  ``unravel`` also takes ``[..., D]``."""
    leaves = [(name, getattr(params, name)) for name in PlatformParams._fields
              if getattr(params, name) is not None]
    shapes = [(name, tuple(x.shape)) for name, x in leaves]
    sizes = [math.prod(shape) for _, shape in shapes]
    if leaves:
        flat = torch.cat([x.reshape(-1).float() for _, x in leaves])
    else:
        flat = torch.zeros(0, dtype=torch.float32)

    def unravel(z: torch.Tensor) -> PlatformParams:
        lead = z.shape[:-1]
        parts = torch.split(z, sizes, -1) if sizes else []
        return PlatformParams(**{name: part.reshape(*lead, *shape)
                                 for (name, shape), part in zip(shapes, parts)})

    return flat, unravel


# --------------------------------------------------------------------------
# lane-batched population objective: the candidate population as the lanes
# of one simulate_many call
# --------------------------------------------------------------------------


def make_population_objective(problem: PlatformProblem, *, objective: str = "engine",
                              loss: str = "mape", include=PARAM_FIELDS,
                              bounds: PlatformBounds | None = None, mesh=None,
                              axis: str = "data", max_rounds: int = 20_000):
    """Build ``batch_eval(z_pop, rng) -> f32[K]`` for a candidate population.

    ``z_pop`` is a ``[K, D]`` block of raveled log-space candidates.  With
    ``objective="engine"`` each row becomes one ensemble lane (its own sites
    and WAN matrix, the shared workload and catalog) and the whole population
    runs as one ``simulate_population``/``simulate_many`` call; the pinned
    replay policy and the resolved subsystems are built once, here.
    ``objective="closed_form"`` evaluates the differentiable walltime model
    for all K candidates at once.

    The returned function carries ``trace_count()``, the number of
    population builds (the port compiles nothing, so this counts calls where
    the JAX package counts traces), and ``z0``/``unravel``/``bounds`` for
    the fitters."""
    p0 = platform_params(problem, include)
    bounds = default_bounds(p0) if bounds is None else bounds
    z0, unravel = ravel_params(encode_params(p0, bounds))
    dev = _device(problem)
    builds: list = []

    if objective == "closed_form":

        def batch_eval(z_pop, rng=None):
            builds.append(None)
            return platform_objective(problem, decode_params(unravel(z_pop), bounds), loss=loss)

    elif objective == "engine":
        from .distributed import simulate_population
        from .engine import Scenario
        from .subsystems import resolve_subsystems

        policy = pinned_policy(problem.hist_site)
        subs, ext0 = resolve_subsystems(
            data_policy=problem.data_policy, network=problem.network0,
            replicas=problem.replicas, availability=problem.availability,
            jobs=problem.jobs, sites=problem.sites0)

        def _build(z_pop) -> Scenario:
            builds.append(None)
            K = z_pop.shape[0]

            def lanes(x):
                return x.expand(K, *x.shape).clone()

            params = decode_params(unravel(z_pop), bounds)
            sites_pop, net_pop = apply_platform_params(
                problem._replace(sites0=_tree_map(lanes, problem.sites0)), params)
            ext_pop = _tree_map(lanes, ext0)
            if "data" in ext_pop and params.bw is not None:
                # lanes stage over their candidate's WAN matrix, not the start's
                ext_pop["data"] = (net_pop._replace(latency=net_pop.latency.clone()),
                                   ext_pop["data"][1])
            return Scenario(jobs=_tree_map(lanes, problem.jobs), sites=sites_pop,
                            ext=ext_pop or None)

        def batch_eval(z_pop, rng=None):
            rng = _rng.PRNGKey(0, dev) if rng is None else rng
            res = simulate_population(_build(z_pop.to(dev)), policy, rng, mesh=mesh, axis=axis,
                                      subsystems=subs, max_rounds=max_rounds, device=dev)
            return _engine_score(problem, res.jobs, loss)

    else:
        raise ValueError(f"unknown objective {objective!r}; have ('closed_form', 'engine')")

    batch_eval.trace_count = lambda: len(builds)
    batch_eval.z0 = z0
    batch_eval.unravel = unravel
    batch_eval.bounds = bounds
    return batch_eval


# --------------------------------------------------------------------------
# fitters over the raveled log-space vector
# --------------------------------------------------------------------------


def _box(z_lo, z_hi):
    return (lambda v: v) if z_lo is None else (lambda v: _clip(v, z_lo, z_hi))


def _host_argmin(f: torch.Tensor):
    """``(i, f[i])`` at the first minimum, in one device-to-host read."""
    fh = f.detach().cpu().numpy()
    i = int(np.argmin(fh))
    return i, float(fh[i])


def spsa(batch_eval, z0: torch.Tensor, rng: torch.Tensor, *, n_iters: int = 100,
         n_dirs: int = 4, a0: float = 0.15, c0: float = 0.1, alpha: float = 0.602,
         gamma: float = 0.101, A: float | None = None, z_lo=None, z_hi=None):
    """Simultaneous-perturbation stochastic approximation, lane-batched.

    Each iteration packs the incumbent plus ``n_dirs`` antithetic Rademacher
    perturbation pairs into one population call of ``2*n_dirs + 1`` lanes.
    Spall's decay schedules; returns ``(best_z, best_f, history)``, history
    the best-so-far loss per iteration."""
    z = z0.float()
    D = z.shape[0]
    A = 0.1 * n_iters if A is None else A
    clip = _box(z_lo, z_hi)
    rng = rng.to(z.device)
    best_z, best_f = z, INF
    hist = []
    for k in range(n_iters):
        rng, k_d, k_e = _rng.split(rng, 3)
        ck = c0 / (k + 1) ** gamma
        ak = a0 / (k + 1 + A) ** alpha
        delta = _rng.rademacher(k_d, (n_dirs, D), torch.float32)
        cand = torch.cat([z[None], clip(z[None] + ck * delta), clip(z[None] - ck * delta)])
        f = batch_eval(cand, k_e)
        fp, fm = f[1:1 + n_dirs], f[1 + n_dirs:]
        ghat = sum_f32((fp - fm)[:, None] * delta, 0) / n_dirs / (2.0 * ck)
        z = clip(z - ak * ghat)
        i, fi = _host_argmin(f)
        if fi < best_f:
            best_z, best_f = cand[i], fi
        hist.append(best_f)
    return best_z, torch.tensor(best_f, dtype=torch.float32), torch.tensor(hist, dtype=torch.float32)


def fit_gradient(obj, z0: torch.Tensor, *, n_iters: int = 200, lr: float = 0.05, z_lo=None,
                 z_hi=None, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam on ``torch.autograd`` of ``obj``.  The schedule terms are float32
    tensors, as in the JAX package's scanned program.  Only meaningful for
    the closed-form objective: the engine's discrete dispatch has no useful
    gradient.  Returns ``(best_z, best_f, history)``."""
    clip = _box(z_lo, z_hi)
    z = z0.float().detach()
    f32 = dict(dtype=torch.float32, device=z.device)
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    best_z, best_f = z, torch.tensor(INF, **f32)
    b1_t, b2_t = torch.tensor(b1, **f32), torch.tensor(b2, **f32)
    hist = []
    for t in range(n_iters):
        zr = z.detach().requires_grad_(True)
        f = obj(zr)
        (g,) = torch.autograd.grad(f, zr)
        f = f.detach()
        best_z = torch.where(f < best_f, z, best_z)
        best_f = torch.minimum(f, best_f)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        tt = torch.tensor(float(t), **f32) + 1.0
        mh = m / (1 - b1_t ** tt)
        vh = v / (1 - b2_t ** tt)
        z = clip(z - lr * mh / (sqrt_f32(vh) + eps))
        hist.append(best_f)
    with torch.no_grad():
        f_last = obj(z)
    best_z = torch.where(f_last < best_f, z, best_z)
    best_f = torch.minimum(f_last, best_f)
    return best_z, best_f, torch.stack(hist) if hist else torch.zeros(0, **f32)


def fit_cma(batch_eval, z0: torch.Tensor, rng: torch.Tensor, *, n_iters: int = 60, pop: int = 0,
            sigma0: float = 0.4, z_lo=None, z_hi=None):
    """CMA-ES over the raveled z vector with lane-batched ranking, the same
    update as ``cma_es`` but on the post-clip displacement.  Each generation
    is one population call of ``pop`` lanes."""
    z0 = z0.float()
    dev = z0.device
    D = z0.shape[0]
    lam = pop or max(8, int(4 + 3 * math.log(max(D, 2))))
    consts = _cma_weights(D, lam, dev)
    clip = _box(z_lo, z_hi)
    m, sigma = z0, torch.tensor(sigma0, dtype=torch.float32, device=dev)
    C, pc, ps = torch.eye(D, device=dev), torch.zeros(D, device=dev), torch.zeros(D, device=dev)
    rng = rng.to(dev)
    best_z, best_f = z0, INF
    hist = []
    for _ in range(n_iters):
        rng, k_s, k_e = _rng.split(rng, 3)
        y, evecs, Dd = _cma_sample(C, k_s, lam)
        x = clip(m[None, :] + sigma * y)
        y = (x - m[None, :]) / sigma     # post-clip displacement keeps the paths honest
        f = batch_eval(x, k_e)
        m, sigma, C, pc, ps = _cma_update(m, sigma, C, pc, ps, y, f, evecs, Dd, consts)
        i, fi = _host_argmin(f)
        if fi < best_f:
            best_z, best_f = x[i], fi
        hist.append(best_f)
    return best_z, torch.tensor(best_f, dtype=torch.float32), torch.tensor(hist, dtype=torch.float32)


# --------------------------------------------------------------------------
# calibrate_platform(): the entry point
# --------------------------------------------------------------------------


class PlatformCalibResult(NamedTuple):
    params0: PlatformParams  # starting point (clipped into bounds)
    params: PlatformParams   # best candidate found (always inside bounds)
    err0: torch.Tensor       # loss at the start
    err: torch.Tensor        # loss at the result (<= err0)
    history: torch.Tensor    # f32[n_iters] best-so-far loss per iteration


PLATFORM_METHODS = ("spsa", "grad", "cma_es")


def calibrate_platform(problem: PlatformProblem, *, method: str = "spsa",
                       objective: str = "closed_form", loss: str = "mape",
                       include=PARAM_FIELDS, bounds: PlatformBounds | None = None,
                       n_iters: int = 100, seed: int = 0, mesh=None, max_rounds: int = 20_000,
                       manifest_out=None, spsa_dirs: int = 4, pop: int = 0, a0: float = 0.15,
                       c0: float = 0.1, lr: float = 0.05) -> PlatformCalibResult:
    """Fit continuous platform knobs to a recorded trace.

    The search space is the ``PlatformParams`` selected by ``include``,
    searched in log space inside ``bounds`` (default: a x30 box around the
    start; results are inside the box by construction).  ``objective`` picks
    the evaluator: ``"closed_form"``, the differentiable walltime model
    (supports ``method="grad"``), or ``"engine"``, the exact engine with
    every candidate of an iteration in the lanes of one ``simulate_many``
    call.  ``method`` is ``"spsa"`` (both objectives), ``"cma_es"`` or
    ``"grad"`` (closed form only).  The result is never worse than the
    start.  The same seed gives the same result.

    ``manifest_out`` writes a run-manifest sidecar
    (``<manifest_out>.manifest.json``) with the scenario hash, the initial
    and final params and the loss curve."""
    if method not in PLATFORM_METHODS:
        raise ValueError(f"unknown method {method!r}; have {PLATFORM_METHODS}")
    if method == "grad" and objective != "closed_form":
        raise ValueError(
            "method='grad' needs objective='closed_form' — the exact engine's "
            "discrete dispatch blocks gradients; use 'spsa' or 'cma_es'"
        )
    dev = _device(problem)
    p0 = platform_params(problem, include)
    bounds = default_bounds(p0) if bounds is None else bounds
    z0, unravel = ravel_params(encode_params(p0, bounds))
    z_lo, _ = ravel_params(encode_params(bounds.lo, bounds))
    z_hi, _ = ravel_params(encode_params(bounds.hi, bounds))
    batch_eval = make_population_objective(
        problem, objective=objective, loss=loss, include=include, bounds=bounds, mesh=mesh,
        max_rounds=max_rounds)
    rng, k_init = _rng.split(_rng.PRNGKey(seed, dev))
    err0 = batch_eval(z0[None], k_init)[0]
    if method == "spsa":
        best_z, best_f, hist = spsa(batch_eval, z0, rng, n_iters=n_iters, n_dirs=spsa_dirs,
                                    a0=a0, c0=c0, z_lo=z_lo, z_hi=z_hi)
    elif method == "cma_es":
        best_z, best_f, hist = fit_cma(batch_eval, z0, rng, n_iters=n_iters, pop=pop,
                                       z_lo=z_lo, z_hi=z_hi)
    else:  # grad
        def obj(z):
            return platform_objective(problem, decode_params(unravel(z), bounds), loss=loss)

        best_z, best_f, hist = fit_gradient(obj, z0, n_iters=n_iters, lr=lr, z_lo=z_lo,
                                            z_hi=z_hi)
    best_f = best_f.to(dev)
    # never return something worse than the starting point
    best_z = torch.where(best_f <= err0, best_z.to(dev), z0)
    err = torch.minimum(best_f, err0)
    result = PlatformCalibResult(
        params0=decode_params(unravel(z0), bounds),
        params=decode_params(unravel(best_z), bounds),
        err0=err0,
        err=err,
        history=torch.minimum(hist.to(dev), err0),
    )
    if manifest_out is not None:
        from .telemetry import jsonable, run_manifest, scenario_hash, write_manifest

        manifest = run_manifest(
            jobs=problem.jobs,
            sites=problem.sites0,
            extra=dict(calibration=dict(
                method=method,
                objective=objective,
                loss=loss,
                include=list(include),
                n_iters=n_iters,
                seed=seed,
                scenario_hash=scenario_hash(problem.jobs, problem.sites0, problem.network0),
                err0=float(err0),
                err=float(err),
                loss_curve=[float(x) for x in result.history],
                params0=jsonable(result.params0),
                params=jsonable(result.params),
                bounds=dict(lo=jsonable(bounds.lo), hi=jsonable(bounds.hi)),
            )),
        )
        write_manifest(manifest_out, manifest)
    return result


# --------------------------------------------------------------------------
# recovery harness: synthetic hidden-truth problems + trace ingestion
# --------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_synthetic_platform_problem(n_jobs: int = 96, n_sites: int = 4, *, seed: int = 0,
                                    include=PARAM_FIELDS, misconfig_sigma: float = 0.6,
                                    noise_sigma: float = 0.0, wan_frac: float = 0.5,
                                    trace: str = "closed_form", max_rounds: int = 20_000,
                                    device="cuda"):
    """Hidden-truth platform problem and the true params (recovery harness).

    A heterogeneous platform and a jittered WAN are the hidden truth; the
    recorded trace is produced at the truth (``trace=`` picks the closed form
    or the exact engine), then every knob in ``include`` is misconfigured by
    ``misconfig_sigma`` in log space.  Cores are plentiful, so the trace has
    no queueing.  WAN jobs each read their own single-replica dataset from a
    source site distinct from their compute site.  numpy's ``default_rng``
    draws what the JAX package draws with it, so those columns match it bit
    for bit.  Returns ``(problem, true_params)``."""
    from .datapolicies import get_data_policy
    from .network import uniform_network, with_bandwidth
    from .platform import atlas_like_platform
    from .replicas import make_replicas
    from .types import resolve_device
    from .workload import synthetic_panda_jobs

    dev = resolve_device(device)
    rng_np = np.random.default_rng(seed)
    sites_true = atlas_like_platform(n_sites, seed=seed, fail_rate=0.0,
                                     cores_range=(4000, 8000), device=dev)
    jobs = synthetic_panda_jobs(n_jobs, seed=seed + 1, duration=6 * 3600.0, device=dev)
    net0 = uniform_network(n_sites, bw=1.25e9, latency=0.02, device=dev)
    jitter = rng_np.lognormal(0.0, 0.5, size=(n_sites, n_sites)).astype(np.float32)
    net_true = with_bandwidth(net0, _np(net0.bw) * jitter)

    w = log_f32(sites_true.cores.float().clamp_min(1.0))
    hist_site = _rng.categorical(_rng.PRNGKey(seed + 2, dev),
                                 w[None, :].expand(jobs.capacity, n_sites)).int()

    J = jobs.capacity
    n_wan = int(round(wan_frac * J))
    data_policy = replicas = None
    hist_src = torch.full((J,), -1, dtype=torch.int32, device=dev)
    hist_bytes = torch.zeros((J,), dtype=torch.float32, device=dev)
    if n_wan > 0:
        wan_rows = np.sort(rng_np.choice(J, size=n_wan, replace=False))
        dataset = np.full(J, -1, np.int32)
        dataset[wan_rows] = np.arange(n_wan)
        hs = _np(hist_site)
        origin = (hs[wan_rows] + 1 + rng_np.integers(0, n_sites - 1, size=n_wan)
                  ).astype(np.int32) % n_sites
        sizes = rng_np.lognormal(np.log(2e9), 0.6, size=n_wan).astype(np.float32)
        replicas = make_replicas(sizes, np.full(n_sites, 1e18, np.float32), origin=origin,
                                 device=dev)
        data_policy = get_data_policy("always_remote")
        jobs = jobs._replace(dataset=torch.from_numpy(dataset).to(dev))
        rows = torch.from_numpy(wan_rows).to(dev)
        hist_src[rows] = torch.from_numpy(origin).to(dev)
        hist_bytes[rows] = torch.from_numpy(sizes).to(dev)

    true_params = PlatformParams(
        speed=sites_true.speed if "speed" in include else None,
        bw=net_true.bw if "bw" in include else None,
        overhead=sites_true.latency if "overhead" in include else None,
    )
    problem_true = PlatformProblem(
        jobs=jobs, sites0=sites_true, network0=net_true, hist_site=hist_site,
        hist_wall=torch.zeros((J,), dtype=torch.float32, device=dev), hist_src=hist_src,
        hist_bytes=hist_bytes, data_policy=data_policy, replicas=replicas,
    )
    if trace == "engine":
        hist_wall = engine_platform_walltimes(problem_true, max_rounds=max_rounds)
    elif trace == "closed_form":
        hist_wall = platform_walltimes(problem_true, PlatformParams())
    else:
        raise ValueError(f"unknown trace {trace!r}; have ('closed_form', 'engine')")
    if noise_sigma > 0:
        hist_wall = hist_wall * exp_f32(
            noise_sigma * _rng.normal(_rng.PRNGKey(seed + 4, dev), tuple(hist_wall.shape)))

    def bad(x, salt):
        key = _rng.PRNGKey(seed + 100 + salt, dev)
        return x * exp_f32(misconfig_sigma * _rng.normal(key, tuple(x.shape)))

    sites0 = sites_true._replace(
        speed=bad(sites_true.speed, 0) if "speed" in include else sites_true.speed,
        latency=bad(sites_true.latency, 1) if "overhead" in include else sites_true.latency,
    )
    network0 = with_bandwidth(net_true, bad(net_true.bw, 2)) if "bw" in include else net_true
    problem = problem_true._replace(sites0=sites0, network0=network0, hist_wall=hist_wall)
    return problem, true_params


def engine_platform_walltimes(problem: PlatformProblem, *, max_rounds: int = 20_000,
                              rng=None) -> torch.Tensor:
    """Walltimes from one exact-engine replay of ``problem`` at its own
    platform (how synthetic traces are recorded; 0 = the job never ran)."""
    dev = _device(problem)
    sites, net = apply_platform_params(problem, PlatformParams())
    res = simulate(problem.jobs, sites, pinned_policy(problem.hist_site),
                   _rng.PRNGKey(0, dev) if rng is None else rng, max_rounds=max_rounds,
                   device=dev, **_problem_sim_kwargs(problem, net))
    return _walltimes_done(res.jobs)


def platform_problem_from_trace(jobs: JobsState, sites0: SiteState, trace: dict, *,
                                network0=None, data_policy=None, replicas=None,
                                availability=None) -> PlatformProblem:
    """A ``PlatformProblem`` from recorded trace rows.

    ``trace`` is ``events.recorded_trace(result)``, an ``events.ml_dataset``
    dict or ``events.read_ml_trace(path)``: anything with ``job_id``,
    ``site`` and ``walltime`` columns (``xfer_src``/``xfer_bytes``
    optional).  Rows align to workload entries by ``job_id``; jobs the trace
    does not cover get ``hist_wall = 0`` and drop out of the mape and
    quantile losses."""
    dev = jobs.arrival.device
    J = jobs.capacity
    pos = {int(j): i for i, j in enumerate(_np(jobs.job_id))}
    site = np.zeros(J, np.int32)
    wall = np.zeros(J, np.float32)
    src = np.full(J, -1, np.int32)
    nbytes = np.zeros(J, np.float32)
    t_src = trace.get("xfer_src")
    t_bytes = trace.get("xfer_bytes")
    for r, jid in enumerate(np.asarray(trace["job_id"])):
        i = pos.get(int(jid))
        if i is None:
            raise ValueError(f"trace job_id {int(jid)} not in the workload")
        site[i] = trace["site"][r]
        wall[i] = trace["walltime"][r]
        if t_src is not None:
            src[i] = t_src[r]
            nbytes[i] = t_bytes[r] if t_bytes is not None else 0.0

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    return PlatformProblem(
        jobs=jobs, sites0=sites0, network0=network0, hist_site=on_dev(site),
        hist_wall=on_dev(wall), hist_src=on_dev(src) if t_src is not None else None,
        hist_bytes=on_dev(nbytes) if t_src is not None else None,
        data_policy=data_policy, replicas=replicas, availability=availability,
    )


def recovery_error(problem: PlatformProblem, params: PlatformParams,
                   true_params: PlatformParams) -> float:
    """Geomean across knob families of the mean relative error against the
    hidden truth, over *identifiable* entries only: sites the trace ran jobs
    at, WAN links it moved bytes over (numpy, float64)."""
    valid = _np(problem.jobs.valid)
    hs = _np(problem.hist_site)[valid]
    S = problem.sites0.capacity
    used_site = np.zeros(S, bool)
    used_site[np.unique(np.clip(hs, 0, S - 1))] = True

    def rel(a, b):
        b = np.maximum(np.abs(np.asarray(_np(b), np.float64)), 1e-30)
        return np.abs(np.asarray(_np(a), np.float64) / b - 1.0)

    maes = []
    if params.speed is not None and true_params.speed is not None:
        maes.append(rel(params.speed, true_params.speed)[used_site].mean())
    if params.overhead is not None and true_params.overhead is not None:
        maes.append(rel(params.overhead, true_params.overhead)[used_site].mean())
    if params.bw is not None and true_params.bw is not None and problem.hist_src is not None:
        src = _np(problem.hist_src)[valid]
        byt = (_np(problem.hist_bytes)[valid] if problem.hist_bytes is not None
               else np.ones_like(src, np.float32))
        m = (src >= 0) & (src != hs) & (byt > 0)
        used = np.zeros((S, S), bool)
        used[src[m], hs[m]] = True
        if used.any():
            maes.append(rel(params.bw, true_params.bw)[used].mean())
    if not maes:
        return float("nan")
    return float(np.exp(np.mean(np.log(np.maximum(np.asarray(maes), 1e-12)))))
