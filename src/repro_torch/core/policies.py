"""Workload-allocation policies: the CGSim plugin mechanism in PyTorch.

A plugin is a ``Policy`` tuple of plain functions on tensors with the four
extension points of the paper's C++ API (Fig. 2) plus the assignment
combinator:

    paper hook               | Policy field
    -------------------------+----------------------------------------
    getResourceInformation   | init(jobs, sites) -> policy_state
    assignJob                | score(jobs, sites, state, clock, rng) -> f32[J, S]
                             | assign(scores, queued, feasible, sites) -> (site, mask)
    onJobEnd                 | on_step(state, jobs, sites, completed, started, clock)
    onSimulationEnd          | on_end(state, jobs, sites, clock)

The optional ``rank(jobs, sites, state, clock) -> f32[J]`` orders starts
within a site queue: a secondary key after ``jobs.priority``, before arrival
time, higher first.  ``rank=None`` keeps the plain FIFO start order.

Per-site scores are broadcast to ``[J, S]`` as views (``expand``), so a
policy that scores sites alone costs no ``J x S`` memory until the
assignment masks it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import rng as _rng
from .engine import _site_sum, default_assign
from .scan import segment_sum_f32
from .types import ASSIGNED, RUNNING, JobsState, SiteState

NEG = -1e30


class Policy(NamedTuple):
    name: str
    init: Callable
    score: Callable
    assign: Callable
    on_step: Callable
    on_end: Callable
    rank: Callable | None = None  # start-order key within site queues (None = jobs.priority)


def _no_state(jobs, sites):
    return ()


def _keep_state(state, *_):
    return state


def make_policy(
    name: str, score: Callable, *, init=None, assign=None, on_step=None, on_end=None, rank=None,
) -> Policy:
    return Policy(
        name=name,
        init=init or _no_state,
        score=score,
        assign=assign or default_assign,
        on_step=on_step or _keep_state,
        on_end=on_end or _keep_state,
        rank=rank,
    )


# --------------------------------------------------------------------------
# site-load helpers shared by several policies
# --------------------------------------------------------------------------

def _queued_cores(jobs: JobsState, sites: SiteState) -> torch.Tensor:
    """f32[S]: cores demanded by the jobs sitting in each site queue."""
    S = sites.capacity
    q_site = torch.where(jobs.state == ASSIGNED, jobs.site, S)
    return _site_sum(jobs.cores, q_site, S).float()


def site_backlog(jobs: JobsState, sites: SiteState):
    """Per-site queued core-demand and outstanding work (running + queued)."""
    S = sites.capacity
    busy = (jobs.state == RUNNING) | (jobs.state == ASSIGNED)
    r_site = torch.where(busy, jobs.site, S)
    return _queued_cores(jobs, sites), segment_sum_f32(jobs.work, r_site, S)


def _per_site(jobs, row: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-site score ``f32[S]`` to every job (a view)."""
    return row[None, :].expand(jobs.capacity, row.shape[0])


# --------------------------------------------------------------------------
# built-in policies (the paper ships a simple example; we ship a family)
# --------------------------------------------------------------------------

def random_policy(seed_salt: int = 0) -> Policy:
    def score(jobs, sites, state, clock, key):
        return _rng.uniform(_rng.fold_in(key, seed_salt), (jobs.capacity, sites.capacity))

    return make_policy("random", score)


def round_robin() -> Policy:
    """Deterministic round-robin by job id (stateless)."""

    def score(jobs, sites, state, clock, key):
        S = sites.capacity
        want = torch.remainder(jobs.job_id.clamp_min(0), sites.active.sum().clamp_min(1))
        idx = torch.arange(S, device=want.device)[None, :]
        return -torch.remainder(idx - want[:, None], S).float()

    return make_policy("round_robin", score)


def fastest_site() -> Policy:
    def score(jobs, sites, state, clock, key):
        return _per_site(jobs, sites.speed)

    return make_policy("fastest_site", score)


def least_loaded() -> Policy:
    """Prefer the site with the most free-core headroom after its queue drains."""

    def score(jobs, sites, state, clock, key):
        head = (sites.free_cores.float() - _queued_cores(jobs, sites)) / (
            sites.cores.float().clamp_min(1.0)
        )
        return _per_site(jobs, head)

    return make_policy("least_loaded", score)


def data_locality() -> Policy:
    """Minimize stage-in cost (CGSim data-movement policy hook)."""

    def score(jobs, sites, state, clock, key):
        return -(sites.latency[None, :] + jobs.bytes_in[:, None] / sites.bw_in[None, :])

    return make_policy("data_locality", score)


def shortest_wait() -> Policy:
    """Greedy expected-completion-time (backlog drain + own service estimate)."""

    def score(jobs, sites, state, clock, key):
        _, out_work = site_backlog(jobs, sites)
        cap_rate = sites.speed * sites.cores.float().clamp_min(1.0)
        drain = out_work / cap_rate.clamp_min(1e-9)
        mine = jobs.work[:, None] / (
            sites.speed[None, :] * jobs.cores[:, None].float()
        ).clamp_min(1e-9)
        stage = sites.latency[None, :] + jobs.bytes_in[:, None] / sites.bw_in[None, :]
        return -(drain[None, :] + mine + stage)

    return make_policy("shortest_wait", score)


def panda_site_score(jobs, sites, w_speed=1.0, w_free=1.0, w_queue=2.0, w_fail=4.0):
    """The PanDA brokerage score as a per-site vector ``f32[S]``.

    The default weights are powers of two, so every product is exact and the
    sum carries the JAX package's bits whether or not its compiler fuses the
    multiply-adds."""
    cores_f = sites.cores.float().clamp_min(1.0)
    norm_speed = sites.speed / sites.speed.max().clamp_min(1e-9)
    free_frac = sites.free_cores.float() / cores_f
    queue_frac = _queued_cores(jobs, sites) / cores_f
    return (
        w_speed * norm_speed
        + w_free * free_frac
        - w_queue * queue_frac
        - w_fail * sites.fail_rate
    )


def panda_dispatch(w_speed=1.0, w_free=1.0, w_queue=2.0, w_fail=4.0) -> Policy:
    """PanDA-flavoured weighted dispatch (brokerage mixes capability, load,
    reliability): the default policy for the ATLAS case study."""

    def score(jobs, sites, state, clock, key):
        return _per_site(jobs, panda_site_score(jobs, sites, w_speed, w_free, w_queue, w_fail))

    return make_policy("panda_dispatch", score)


def crit_rank_fn(jobs, sites, state, clock):
    """Start-order rank: critical-path weight (``jobs.priority`` stays the
    primary key)."""
    return jobs.wf_crit


def critical_path_first(base: str = "panda_dispatch", **params) -> Policy:
    """Site choice follows the ``base`` policy, but within each site queue
    jobs start in decreasing critical-path weight ``jobs.wf_crit``.  On
    DAG-free workloads ``wf_crit`` is 0 everywhere, so this degrades to the
    base policy."""
    pol = get_policy(base, **params)
    return pol._replace(name=f"critical_path_first[{pol.name}]", rank=crit_rank_fn)


def with_capacity_assign(policy: Policy, assign_fn) -> Policy:
    """Swap in a capacity-constrained assigner (e.g.
    ``repro_torch.kernels.assign.make_capacity_assign``): jobs beyond a site's
    free cores stay QUEUED at the main server instead of piling into site
    queues."""

    def assign(scores, queued, feasible, sites):
        return assign_fn(scores, queued, feasible, sites)

    return policy._replace(name=policy.name + "+capacity", assign=assign)


REGISTRY: dict[str, Callable[..., Policy]] = {
    "random": random_policy,
    "round_robin": round_robin,
    "fastest_site": fastest_site,
    "least_loaded": least_loaded,
    "data_locality": data_locality,
    "shortest_wait": shortest_wait,
    "panda_dispatch": panda_dispatch,
    "critical_path_first": critical_path_first,
}


def get_policy(name: str, **params) -> Policy:
    if name not in REGISTRY:
        raise KeyError(f"unknown policy {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**params)


def register(name: str):
    """Decorator: plug a user policy factory into the registry (paper §3.3)."""

    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


class AllocationPlugin:
    """Subclass and override, then call ``.build()`` to get a Policy.

    Mirrors CGSim's abstract plugin class: ``get_resource_information`` is
    called once with the platform; ``assign_job`` must produce per-site scores
    for every queued job; ``on_job_end``/``on_simulation_end`` are optional.
    """

    name = "custom"

    def get_resource_information(self, jobs: JobsState, sites: SiteState):
        return ()

    def assign_job(self, jobs, sites, state, clock, key):  # -> f32[J, S]
        raise NotImplementedError

    def on_job_end(self, state, jobs, sites, completed, started, clock):
        return state

    def on_simulation_end(self, state, jobs, sites, clock):
        return state

    def build(self) -> Policy:
        return Policy(
            name=self.name,
            init=self.get_resource_information,
            score=self.assign_job,
            assign=default_assign,
            on_step=self.on_job_end,
            on_end=self.on_simulation_end,
        )
