"""State carried between numpy and the port.

``jobs_from_numpy``/``sites_from_numpy`` take a mapping of field name to
array (what ``{k: np.asarray(v) for k, v in state._asdict().items()}`` gives
for a JAX-package ``JobsState``/``SiteState``) and build the port's state on
a device; ``result_to_numpy`` turns a ``SimResult`` back into nested dicts of
numpy arrays.  The tests feed both implementations identical inputs this way.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import JobsState, SimResult, SiteState, resolve_device


def _from_numpy(cls, arrays, device):
    device = resolve_device(device)
    missing = [f for f in cls._fields if f not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(**{
        f: torch.from_numpy(np.array(arrays[f], copy=True)).to(device) for f in cls._fields
    })


def jobs_from_numpy(arrays, device="cuda") -> JobsState:
    return _from_numpy(JobsState, arrays, device)


def sites_from_numpy(arrays, device="cuda") -> SiteState:
    return _from_numpy(SiteState, arrays, device)


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    return np.asarray(value)


def result_to_numpy(res: SimResult) -> dict:
    """``{"makespan", "rounds", "jobs": {...}, "sites": {...}, "log": {...}}``."""
    return dict(
        makespan=_to_numpy(res.makespan),
        rounds=np.int32(res.rounds),
        jobs=_to_numpy(res.jobs),
        sites=_to_numpy(res.sites),
        log=_to_numpy(res.log),
    )
