"""State carried between numpy and the port.

``jobs_from_numpy``/``sites_from_numpy``/``availability_from_numpy``/
``workflow_from_numpy``/``network_from_numpy``/``replicas_from_numpy``/
``transfers_from_numpy``/``faults_from_numpy`` take a mapping of field name to array (what
``{k: np.asarray(v) for k, v in state._asdict().items()}`` gives for the JAX
package's state of the same name) and build the port's state on a device;
``scenario_from_numpy`` builds an ensemble's ``Scenario`` from such
mappings (its ``ext`` keyed by subsystem name); ``calib_problem_from_numpy``
and ``platform_problem_from_numpy`` build calibration problems from a
mapping of problem field to such mappings and arrays; ``result_to_numpy`` turns a
``SimResult`` back into nested dicts of numpy arrays, through ``to_numpy``.
The tests feed both implementations identical inputs this way.
"""
from __future__ import annotations

import numpy as np
import torch

from .availability import AvailabilityState
from .faults import FaultState
from .network import NetworkState
from .replicas import ReplicaState
from .transfers import TransferState
from .types import JobsState, SimResult, SiteState, resolve_device
from .workflows import WorkflowState


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


def availability_from_numpy(arrays, device="cuda") -> AvailabilityState:
    return _from_numpy(AvailabilityState, arrays, device)


def workflow_from_numpy(arrays, device="cuda") -> WorkflowState:
    return _from_numpy(WorkflowState, arrays, device)


def network_from_numpy(arrays, device="cuda") -> NetworkState:
    return _from_numpy(NetworkState, arrays, device)


def replicas_from_numpy(arrays, device="cuda") -> ReplicaState:
    return _from_numpy(ReplicaState, arrays, device)


def transfers_from_numpy(arrays, device="cuda") -> TransferState:
    return _from_numpy(TransferState, arrays, device)


def faults_from_numpy(arrays, device="cuda") -> FaultState:
    return _from_numpy(FaultState, arrays, device)


_EXT_STATES = {"availability": AvailabilityState, "workflow": WorkflowState,
               "transfers": TransferState, "faults": FaultState}


def _ext_from_numpy(name, arrays, device):
    if name == "data":
        network, replicas = arrays
        return (_from_numpy(NetworkState, network, device),
                _from_numpy(ReplicaState, replicas, device))
    return _from_numpy(_EXT_STATES[name], arrays, device)


def scenario_from_numpy(jobs, sites, ext=None, device="cuda"):
    """An ensemble ``Scenario`` from field-to-array mappings: ``jobs`` and
    ``sites`` as for ``jobs_from_numpy``/``sites_from_numpy``, ``ext`` a
    mapping of subsystem name (``"availability"``, ``"workflow"``,
    ``"transfers"``, ``"faults"``) to its state's mapping, and ``"data"`` to
    a ``(network, replicas)`` pair of them."""
    from .engine import Scenario

    return Scenario(
        jobs_from_numpy(jobs, device), sites_from_numpy(sites, device),
        {name: _ext_from_numpy(name, arrays, device) for name, arrays in (ext or {}).items()},
    )


def _tensor(a, device):
    return None if a is None else torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def calib_problem_from_numpy(arrays, device="cuda"):
    """A ``calibration.CalibProblem`` from ``{"jobs": {...}, "sites0": {...},
    "hist_site": array, "hist_wall": array, "n_sites": int}``."""
    from .calibration import CalibProblem

    return CalibProblem(
        jobs=jobs_from_numpy(arrays["jobs"], device),
        sites0=sites_from_numpy(arrays["sites0"], device),
        hist_site=_tensor(arrays["hist_site"], device),
        hist_wall=_tensor(arrays["hist_wall"], device),
        n_sites=int(arrays["n_sites"]),
    )


def platform_problem_from_numpy(arrays, device="cuda"):
    """A ``calibration.PlatformProblem`` from a mapping of its fields:
    ``jobs``/``sites0``/``network0``/``replicas``/``availability`` as
    mappings of their states' fields (or ``None``), the ``hist_*`` columns as
    arrays (or ``None``), and ``data_policy`` as a registered data policy's
    name, a port ``DataPolicy`` or ``None``."""
    from .calibration import PlatformProblem
    from .datapolicies import get_data_policy

    def state(name, cls):
        value = arrays.get(name)
        return None if value is None else _from_numpy(cls, value, device)

    policy = arrays.get("data_policy")
    return PlatformProblem(
        jobs=jobs_from_numpy(arrays["jobs"], device),
        sites0=sites_from_numpy(arrays["sites0"], device),
        network0=state("network0", NetworkState),
        hist_site=_tensor(arrays.get("hist_site"), device),
        hist_wall=_tensor(arrays.get("hist_wall"), device),
        hist_src=_tensor(arrays.get("hist_src"), device),
        hist_bytes=_tensor(arrays.get("hist_bytes"), device),
        data_policy=get_data_policy(policy) if isinstance(policy, str) else policy,
        replicas=state("replicas", ReplicaState),
        availability=state("availability", AvailabilityState),
    )


def to_numpy(value):
    """A tensor on any device as a numpy array; NamedTuple states and dicts
    as dicts of them; any other value through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_asdict"):
        return {k: to_numpy(v) for k, v in value._asdict().items()}
    return np.asarray(value)


def result_to_numpy(res: SimResult) -> dict:
    """``{"makespan", "rounds", "jobs": {...}, "sites": {...}, "log": {...}}``,
    plus ``"avail"``, ``"wf"``, ``"replicas"``, ``"data_state"``,
    ``"transfers"`` and ``"faults"`` when those subsystems ran."""
    out = dict(
        makespan=to_numpy(res.makespan),
        rounds=np.int32(res.rounds) if isinstance(res.rounds, int) else to_numpy(res.rounds),
        jobs=to_numpy(res.jobs),
        sites=to_numpy(res.sites),
        log=to_numpy(res.log),
    )
    for name in ("avail", "wf", "replicas"):
        if getattr(res, name) is not None:
            out[name] = to_numpy(getattr(res, name))
    if res.replicas is not None:
        out["data_state"] = to_numpy(res.data_state)
    for name in ("transfers", "faults"):
        if name in (res.ext or {}):
            out[name] = to_numpy(res.ext[name])
    return out
