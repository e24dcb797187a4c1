"""Hand-written Hopper kernels, each beside its plain PyTorch version: a
wrapper launches the kernel for CUDA tensors and runs the plain version for
CPU tensors."""
