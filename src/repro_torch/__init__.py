"""CGSim on PyTorch and CUDA: the port of the JAX package ``repro``.

The same event-round grid simulator with the same layout and names
(``repro_torch.core.engine.simulate``, ``repro_torch.kernels.assign.ops``,
...), written for an NVIDIA H100.  Entry points run on the GPU unless the
caller passes ``device="cpu"``; every TPU kernel of the ported path is a CUDA
kernel written by hand (``kernels/*/csrc``) beside its plain PyTorch version.
"""
