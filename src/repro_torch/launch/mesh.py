"""Production mesh definitions and the H100's roofline constants.

``make_production_mesh`` builds the 16 x 16 (one pod) or 2 x 16 x 16 (two
pods) ``DeviceMesh`` on a *fake* process group: every collective returns at
once without moving data, so a cell's step can be traced on meta tensors
as rank 0 of 256 or 512 sees it (the JAX package forces 512 host devices
with ``--xla_force_host_platform_device_count``).  One fake world of 512
ranks holds both meshes.  Functions, not module-level constants: importing
this module starts no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.sharding import AbstractMesh

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3 bandwidth,
# and NVLink 4 at 900 GB/s per card both ways, 450 GB/s each way
PEAK_FLOPS_BF16 = 989e12   # FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card
ICI_BW = 450e9             # bytes/s per card, each way (NVLink 4)

FAKE_WORLD = 512


def _fake_store():
    """The fake process group's store; the module lives under
    ``torch.testing._internal``, so it is imported here and nowhere else."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:   # pragma: no cover - a torch without its testing package
        raise RuntimeError("the production mesh needs torch.testing._internal.distributed."
                           "fake_pg (the fake process group), which this torch lacks") from e
    return FakeStore()


def init_fake_world(world_size: int = FAKE_WORLD) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0; a fake group already there of at least that size
    is kept, any other group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is already the default: "
                               "the production mesh needs a fake one (run it in its own process)")
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"the fake world has {dist.get_world_size()} ranks, not "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=_fake_store(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 cards per pod; 2 pods = 512 cards multi-pod, on a fake
    process group (see the module docstring); rank 0's view."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world()
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).view(shape), mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """The cards this host really has as ``(n // model, model)`` over
    ("data", "model"): a ``DeviceMesh`` over the world of the initialized
    default process group, else, with no group to build one on, an
    ``AbstractMesh`` of the same names and sizes over
    ``torch.cuda.device_count()`` (all that ``specs.build_cell`` reads)."""
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        n = dist.get_world_size()
        return init_device_mesh("cuda", (max(n // model, 1), model),
                                mesh_dim_names=("data", "model"))
    n = torch.cuda.device_count()
    return AbstractMesh((max(n // model, 1), model), ("data", "model"))
