"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``: they skip where no GPU is present.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: ``idx``, ``admit`` and ``pos`` are exact (integral sizes make
every prefix sum exact in f32); ``gate`` uses rtol 1e-5, atol 1e-6 (``expf``
rounding and summation order).  Segment sums are exact against the CPU's
row-order sums.  The fused candidate-set assignment's ``site`` and ``admit``
are exact (integral sizes again).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.assign.fused_ref import fused_assign_ref  # noqa: E402
from repro_torch.kernels.assign.ref import assign_ref  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_ref  # noqa: E402

ASSIGN_CASES = [
    # (N, E, k, block_n)
    (64, 8, 1, 32),
    (128, 16, 2, 64),
    (256, 384, 8, 256),
    (100, 50, 1, 256),
    (33, 7, 3, 16),
    (512, 32, 8, 128),
    (100_000, 300, 1, 256),   # the engine's WLCG-scale dispatch shape
    (1000, 20, 2, 512),       # block_n above the kernel's 256-thread chunk
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _inputs(N, E, seed, device):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.1] = -1e30
    sizes = rng.choice([1.0, 2.0, 8.0], size=N).astype(np.float32)
    caps = (rng.uniform(2, 40, size=E) * max(1.0, N / (10 * E))).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (scores, sizes, caps))


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,k,bn", ASSIGN_CASES)
def test_assign_kernel_matches_plain(cuda_device, N, E, k, bn):
    from repro_torch.kernels.assign import assign_cuda as mod

    scores, sizes, caps = _inputs(N, E, N + E, cuda_device)
    want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
    before = mod.launches
    got = mod.assign_cuda(scores, sizes, caps, k=k, block_n=bn)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)


@pytest.mark.cuda
def test_assign_dispatches_cuda_tensors_to_the_kernel(cuda_device):
    from repro_torch.kernels.assign import assign
    from repro_torch.kernels.assign import assign_cuda as mod

    scores, sizes, caps = _inputs(64, 8, 0, cuda_device)
    before = mod.launches
    assign(scores, sizes, caps, k=1)
    assert mod.launches == before + 1
    with pytest.raises(TypeError):
        mod.assign_cuda(scores.double(), sizes, caps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,features", [(torch.float32, 1), (torch.int32, 3)])
def test_segment_sum_kernel_matches_row_order(cuda_device, dtype, features):
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.lognormal(1.0, 1.0, (100_000, features)).astype(np.float32))
    v = v.to(dtype).squeeze(1) if features == 1 else v.to(dtype)
    seg = torch.from_numpy(rng.integers(-1, 302, 100_000).astype(np.int32))
    want = segment_sum_ref(v, seg, 300)                  # the CPU's row-order sums
    got = segment_sum_cuda(v.to(cuda_device), seg.to(cuda_device), 300)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


FUSED_CASES = [
    # (N, E, K, block_n, sentinel_rows)
    (97, 7, 4, 32, False),
    (97, 7, 4, 32, True),          # half the rows all-sentinel
    (1000, 300, 48, 256, False),   # K above a warp
    (2048, 50, 50, 256, False),    # every site a candidate
    (100_000, 300, 16, 256, False),  # the sparse engine shape (topk=16)
    (100_000, 300, 16, 256, True),
]


def _fused_inputs(N, E, K, seed, device, sentinel_rows):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, K)).astype(np.float32)
    cand = np.argsort(rng.random((N, E)), axis=1)[:, :K]
    filled = rng.integers(0, K + 1, N)
    cand = np.where(np.arange(K)[None, :] < filled[:, None], cand, E)
    if sentinel_rows:
        cand[rng.random(N) < 0.5] = E
    cand = np.sort(cand, axis=1).astype(np.int32)
    sizes = rng.choice([1.0, 2.0, 8.0], size=N).astype(np.float32)
    caps = (rng.uniform(2, 40, size=E) * max(1.0, N / (10 * E))).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (scores, cand, sizes, caps))


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,K,bn,sentinel_rows", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda_device, N, E, K, bn, sentinel_rows):
    from repro_torch.kernels.assign import fused_cuda as mod

    args = _fused_inputs(N, E, K, N + E + K, cuda_device, sentinel_rows)
    want = fused_assign_ref(*args, block_n=bn)
    before = mod.launches
    got = mod.fused_assign_cuda(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    if sentinel_rows:
        empty = (args[1] == E).all(-1)
        assert (got[0][empty] == -1).all() and not got[1][empty].any()


@pytest.mark.cuda
def test_fused_topk_assign_dispatches_cuda_tensors_to_the_kernel(cuda_device):
    from repro_torch.kernels.assign import fused_cuda as mod
    from repro_torch.kernels.assign import fused_topk_assign

    args = _fused_inputs(97, 7, 4, 0, cuda_device, False)
    before = mod.launches
    fused_topk_assign(*args)
    assert mod.launches == before + 1
    with pytest.raises(TypeError):
        mod.fused_assign_cuda(args[0], args[1].long(), args[2], args[3])
