"""Candidate-population ensembles behind one entry point.

The JAX package spreads simulations over a device mesh here (jobs sharded
over an axis, ensemble lanes split across devices).  The port has the
single-device branch only: ``simulate_population(mesh=None)`` is
``simulate_many``.  Runs over several devices are ROADMAP Queue 1 item 13;
until then a mesh raises rather than running on one device.
"""
from __future__ import annotations

import torch

from .engine import simulate_many
from .types import SimResult


def simulate_population(
    scenarios,
    policy,
    rng: torch.Tensor,
    *,
    mesh=None,
    axis: str = "data",
    subsystems: tuple = (),
    **kw,
) -> SimResult:
    """One entry point for candidate-population ensembles (calibration
    lanes): ``mesh=None`` runs the lanes through ``simulate_many`` on one
    device, lane ``i`` under ``split(rng, K)[i]``.  ``kw`` as for
    ``simulate_many`` (``device=`` included).  A mesh raises
    ``NotImplementedError``: multi-device lanes are ROADMAP Queue 1 item 13."""
    if mesh is not None:
        raise NotImplementedError(
            "simulate_population(mesh=...) spreads lanes over devices, which the port does "
            "not do yet (ROADMAP Queue 1 item 13, multi-device); pass mesh=None")
    return simulate_many(scenarios, policy, rng, subsystems=subsystems, **kw)
