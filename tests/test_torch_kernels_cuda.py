"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``: they skip where no GPU is present.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: ``idx``, ``admit`` and ``pos`` are exact (integral sizes make
every prefix sum exact in f32); ``gate`` uses rtol 1e-5, atol 1e-6 (``expf``
rounding and summation order).  Segment sums are bit for bit the CPU's
row-order sums, signed zeros included.  The fused candidate-set assignment's ``site`` and ``admit``
are exact (integral sizes again).  The flash-attention kernel holds
``attention_ref`` to max abs error 2e-5 in float32 and 2e-2 in bfloat16 (the
kernel sums in another order; bf16 outputs round at 2^-8), and a 2-layer
model's prefill through it holds the plain ``chunked_attention`` path to
1e-4 (f32) and 2e-2 (bf16) of the largest logit.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.assign.fused_ref import fused_assign_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, chunked_attention  # noqa: E402
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
    (1000, 20, 2, 512),       # block_n above the kernel's 256-row tile
    (1000, 301, 1, 256),      # E % 4 != 0: rows not 16-byte aligned
    (777, 7, 3, 100),         # E % 4 != 0, block_n dividing neither N nor the tile
    (2000, 512, 8, 256),      # the widest MoE router, k = 8
    (600, 700, 2, 128),       # E above the 512 bins kept in registers
    (5000, 64, 4, 300),       # block_n not dividing N, several tiles a block
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
@pytest.mark.parametrize("kind,N,E,k,bn", [
    ("infeasible_rows", 3000, 300, 1, 256),
    ("infeasible_rows", 700, 33, 4, 64),
    ("ties", 3000, 300, 1, 256),
    ("ties", 900, 40, 8, 128),
])
def test_assign_kernel_matches_plain_on_edge_rows(cuda_device, kind, N, E, k, bn):
    """Rows with no feasible bin (-1e30 and -inf), and scores with many ties
    (three levels and signed zeros: ties go to the lowest bin)."""
    from repro_torch.kernels.assign import assign_cuda as mod

    rng = np.random.default_rng(N + E + k)
    if kind == "ties":
        scores = rng.choice(np.array([0.0, -0.0, 1.0, 2.0], np.float32), size=(N, E))
        scores[rng.random((N, E)) < 0.2] = -1e30
    else:
        scores = rng.normal(size=(N, E)).astype(np.float32)
        scores[rng.random(N) < 0.3] = -1e30
        scores[rng.random(N) < 0.1] = -np.inf
    sizes = rng.choice([1.0, 2.0, 8.0], size=N).astype(np.float32)
    caps = (rng.uniform(2, 40, size=E) * max(1.0, N * k / (10 * E))).astype(np.float32)
    scores, sizes, caps = (torch.from_numpy(x).to(cuda_device) for x in (scores, sizes, caps))
    want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
    got = mod.assign_cuda(scores, sizes, caps, k=k, block_n=bn)
    torch.cuda.synchronize()
    for w, g in zip((want[0], want[2], want[3]), (got[0], got[2], got[3])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert got[2].any() and (kind == "ties" or (got[0] == -1).any())


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


SEGSUM_CASES = [
    # (mix, J, S, F, dtype, id dtype)
    ("mostly_padding", 100_000, 300, 1, torch.float32, torch.int32),
    ("mostly_padding", 100_000, 300, 3, torch.int32, torch.int32),
    ("one_segment", 100_000, 300, 1, torch.float32, torch.int32),
    ("one_segment", 50_000, 50, 2, torch.float32, torch.int64),
    ("out_of_range", 10_007, 37, 4, torch.float32, torch.int64),
    ("out_of_range", 10_007, 37, 4, torch.int32, torch.int32),
    ("uniform", 4097, 9, 3, torch.float32, torch.int32),     # J not a multiple of the chunk
    ("uniform", 100_003, 301, 2, torch.float32, torch.int64),
    ("uniform", 1, 5, 1, torch.float32, torch.int32),
    ("uniform", 0, 5, 2, torch.float32, torch.int32),        # J = 0
    ("signed_zeros", 3000, 20, 1, torch.float32, torch.int32),
    ("signed_zeros", 3000, 20, 4, torch.float32, torch.int64),
]


def _segsum_inputs(mix, J, S, F, dtype, id_dtype, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S + 1, J)                       # S: the padding segment
    if mix == "mostly_padding":
        ids = np.where(rng.random(J) < 0.95, S, ids)
    elif mix == "one_segment":
        ids = np.where(rng.random(J) < 0.999, S // 2, ids)
    elif mix == "out_of_range":
        ids = rng.integers(-3 * S, 3 * S, J)              # negative and > S
    if dtype == torch.float32:
        v = rng.lognormal(1.0, 1.0, (J, F)).astype(np.float32)
        if mix == "signed_zeros":
            v[rng.random((J, F)) < 0.5] = -0.0
            ids = np.where(ids % 4 == 0, S, ids)          # segments 0, 4, 8, ... empty
            v[ids % 4 == 1] = -0.0                        # 1, 5, 9, ... only -0.0 rows
            ids[ids == 1] = S
            ids[7], v[7] = 1, -0.0                        # and segment 1 a lone -0.0
    else:
        v = rng.integers(-(2**20), 2**20, (J, F)).astype(np.int32)
    v = torch.from_numpy(v if F > 1 else v[:, 0].copy())
    return v, torch.from_numpy(ids).to(id_dtype)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("mix,J,S,F,dtype,id_dtype", SEGSUM_CASES)
def test_segment_sum_kernel_matches_row_order_on_id_mixes(cuda_device, mix, J, S, F, dtype,
                                                         id_dtype):
    """Bit for bit (signed zeros included) against the CPU's row-order sums,
    in one launch."""
    from repro_torch.kernels.segment_sum import segment_sum_cuda as mod

    v, seg = _segsum_inputs(mix, J, S, F, dtype, id_dtype, J + S + F)
    want = segment_sum_ref(v, seg, S)
    before = mod.launches
    got = mod.segment_sum_cuda(v.to(cuda_device), seg.to(cuda_device), S).cpu()
    assert mod.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))
    if mix == "signed_zeros":
        assert (_bits(got[0::4]) == 0).all() and (_bits(got[1::4]) == 0).all()  # +0.0


MANY_SEGMENTS = 300 * 300 + 1   # the link sums' S*S + 1 segments at S=300


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["uniform", "mostly_padding"])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segment_sum_kernel_takes_many_segments(cuda_device, mix, F, dtype):
    """Past the one-launch cap of 25599 segments: f32 in windows of
    segments, i32 added directly; both bit for bit the CPU's row-order sums."""
    from repro_torch.kernels.segment_sum import segment_sum_cuda as mod

    v, seg = _segsum_inputs(mix, 100_000, MANY_SEGMENTS, F, dtype, torch.int32, F + 11)
    want = segment_sum_ref(v, seg, MANY_SEGMENTS)
    before = mod.launches
    got = mod.segment_sum_cuda(v.to(cuda_device), seg.to(cuda_device), MANY_SEGMENTS).cpu()
    assert mod.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_device(cuda_device):
    """With cuda:0 current, every wrapper given tensors on cuda:1 launches
    there and matches its plain version; the segment sum sets its launch
    state (shared-memory attribute, occupancy) for each device it meets."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels.assign.assign_cuda import assign_cuda
    from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda
    from repro_torch.kernels.flash_attention.flash_attention_cuda import flash_attention_cuda
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    torch.cuda.set_device(0)
    for S in (5000, 300):  # 5000: above 48 KB of dynamic shared memory
        v, seg = _segsum_inputs("uniform", 50_000, S, 1, torch.float32, torch.int32, S)
        want = segment_sum_ref(v, seg, S)
        for dev in ("cuda:0", "cuda:1", "cuda:0"):
            got = segment_sum_cuda(v.to(dev), seg.to(dev), S)
            assert got.device == torch.device(dev)
            assert torch.equal(_bits(got.cpu()), _bits(want))
    d1 = torch.device("cuda:1")
    scores, sizes, caps = _inputs(5000, 64, 1, d1)
    want = assign_ref(scores.cpu(), sizes.cpu(), caps.cpu(), k=2)
    got = assign_cuda(scores, sizes, caps, k=2)
    assert got[0].device == d1 and torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    args = _fused_inputs(5000, 300, 16, 3, d1, False)
    want = fused_assign_ref(*(a.cpu() for a in args))
    got = fused_assign_cuda(*args)
    assert got[0].device == d1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    q, k, v = _flash_inputs(1, 4, 2, 256, 256, 128, torch.bfloat16, 0, d1)
    got = flash_attention_cuda(q, k, v)
    assert got.device == d1
    want = attention_ref(q.float().cpu(), k.float().cpu(), v.float().cpu())
    assert float((got.float().cpu() - want).abs().max()) <= 2e-2
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_segment_sum_kernel_reads_unaligned_ids(cuda_device):
    """ids that do not start on 16 bytes take the kernel's plain loads."""
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    v, seg = _segsum_inputs("uniform", 20_001, 300, 1, torch.float32, torch.int32, 3)
    buf = torch.empty(seg.numel() + 1, dtype=torch.int32, device=cuda_device)
    shifted = buf[1:].copy_(seg.to(cuda_device))
    assert shifted.data_ptr() % 16 != 0
    got = segment_sum_cuda(v.to(cuda_device), shifted, 300).cpu()
    assert torch.equal(_bits(got), _bits(segment_sum_ref(v, seg, 300)))


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


FUSED_EDGE_CASES = [
    # (N, E, K, kind)
    (1, 7, 4, "random"),               # N = 1
    (1000, 300, 16, "random"),         # N not a multiple of the 256-row tile
    (5000, 300, 16, "one_site"),       # every row claims one site: the longest chain
    (3000, 300, 16, "sentinel_tile"),  # a whole tile of sentinel rows
    (3000, 50, 1, "random"),           # K = 1: one lane a row
    (3000, 50, 3, "random"),           # K = 3: no 16-byte loads
    (3000, 50, 8, "random"),           # K = 8: two lanes a row
    (20000, 512, 16, "random"),        # E = 512
    (5000, 300, 16, "boundary"),       # sizes 8 against caps right at the boundary
    (3000, 6000, 8, "random"),         # bases and caps past the kernel's shared memory
    (3000, 20000, 8, "random"),        # sites past the kernel's shared-memory totals
    (2000, 40, 150, "random"),         # K > 128: several groups of 4 slots a lane
]


def _fused_edge_inputs(N, E, K, kind, seed, device):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, K)).astype(np.float32)
    cand = np.stack([np.sort(rng.choice(E, min(K, E), replace=False)) for _ in range(N)])
    cand = np.concatenate([cand, np.full((N, K - cand.shape[1]), E)], axis=1)
    filled = rng.integers(0, K + 1, N)
    cand = np.where(np.arange(K)[None, :] < filled[:, None], cand, E).astype(np.int32)
    sizes = rng.choice([1.0, 2.0, 8.0], size=N).astype(np.float32)
    caps = (rng.uniform(2, 40, size=E) * max(1.0, N / (10 * E))).astype(np.float32)
    if kind == "sentinel_tile":
        cand[256:512] = E
    elif kind == "one_site":
        cand[:] = E
        cand[:, 0] = 3
        caps[3] = sizes.sum() // 2
    elif kind == "boundary":
        sizes[:] = 8.0
        caps = (8 * rng.integers(0, 2 * N // E + 2, size=E)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (scores, cand, sizes, caps))


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,K,kind", FUSED_EDGE_CASES)
def test_fused_kernel_matches_plain_on_edge_cases(cuda_device, N, E, K, kind):
    from repro_torch.kernels.assign import fused_cuda as mod

    args = _fused_edge_inputs(N, E, K, kind, N + E + K, cuda_device)
    want = fused_assign_ref(*args)
    before = mod.launches
    got = mod.fused_assign_cuda(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "one_site":
        assert 0 < int(got[1].sum()) < N
    if kind == "boundary":  # some admitted row ends exactly at its site's cap
        site, admit = (t.cpu().numpy() for t in got)
        sizes, caps = (t.cpu().numpy() for t in args[2:])
        used, exact = np.zeros(E, np.float32), 0
        for r in np.flatnonzero(site >= 0):  # claims in row order
            exact += bool(admit[r] and used[site[r]] + sizes[r] == caps[site[r]])
            used[site[r]] += sizes[r]
        assert exact > 0


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


FLASH_CASES = [
    # (B, Hq, Hkv, S, Skv, D, causal, window, dtype)
    (1, 4, 4, 256, 256, 64, True, 0, torch.float32),    # tests/test_kernels.py's six
    (2, 8, 2, 128, 128, 64, True, 0, torch.float32),
    (1, 4, 1, 384, 384, 128, True, 0, torch.float32),
    (1, 4, 2, 256, 256, 64, True, 64, torch.float32),
    (1, 8, 8, 256, 256, 64, True, 0, torch.bfloat16),
    (2, 4, 2, 200, 200, 64, True, 96, torch.bfloat16),
    (1, 2, 2, 100, 100, 32, False, 0, torch.float32),   # non-causal, ragged Skv
    (2, 4, 2, 100, 300, 64, True, 0, torch.float32),    # q right-aligned, Skv > S
    (4, 32, 32, 4096, 4096, 128, True, 0, torch.bfloat16),  # deepseek-7b prefill
    (1, 2, 1, 70, 70, 16, True, 0, torch.bfloat16),     # tensor-core path, smallest D
    (1, 2, 2, 100, 100, 96, False, 0, torch.bfloat16),  # tensor-core path, non-causal ragged
    (1, 4, 2, 130, 200, 192, True, 64, torch.bfloat16),  # bf16 on the CUDA-core path (D > 128)
    # the wgmma/TMA path (bf16, D = 64 or 128): ragged tails of 128-row tiles,
    # right-aligned q, tiles wholly inside a window, qwen2.5-32b's GQA, no causality
    (1, 4, 2, 1000, 1000, 128, True, 0, torch.bfloat16),
    (2, 4, 2, 300, 1000, 128, True, 0, torch.bfloat16),
    (1, 4, 4, 1024, 1024, 128, True, 256, torch.bfloat16),
    (1, 40, 8, 2048, 2048, 128, True, 0, torch.bfloat16),
    (2, 4, 2, 200, 200, 128, False, 0, torch.bfloat16),
    (1, 4, 2, 1000, 1000, 64, True, 0, torch.bfloat16),
    (1, 4, 1, 700, 900, 64, True, 200, torch.bfloat16),
    # whisper-small at D = 64 on the wgmma path, no causality, 1500 frames (not
    # a multiple of the key tile): the encoder, and the cross-attention of a
    # 32-token prompt and of one decode token
    (1, 12, 12, 1500, 1500, 64, False, 0, torch.bfloat16),
    (1, 12, 12, 32, 1500, 64, False, 0, torch.bfloat16),
    (1, 12, 12, 1, 1500, 64, False, 0, torch.bfloat16),
    # the wgmma/TMA path at D = 256 (64-key tiles): ragged tiles, right-aligned
    # q, recurrentgemma's window on one KV head (Hkv = 1), no causality
    (1, 4, 2, 300, 300, 256, True, 0, torch.bfloat16),
    (2, 4, 2, 100, 333, 256, True, 0, torch.bfloat16),
    (1, 10, 1, 1000, 1000, 256, True, 200, torch.bfloat16),
    (1, 4, 4, 200, 200, 256, False, 0, torch.bfloat16),
    # more queries than keys under causality: the first rows keep no key
    # (output 0, log-sum-exp +inf), on the wgmma, mma.sync and f32 paths
    (1, 2, 2, 100, 60, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 90, 40, 256, True, 0, torch.bfloat16),
    (1, 2, 1, 80, 50, 32, True, 0, torch.bfloat16),
    (1, 2, 1, 80, 50, 32, True, 0, torch.float32),
]


def _flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dtype) for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,Skv,D,causal,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, B, Hq, Hkv, S, Skv, D, causal, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_cuda as mod

    q, k, v = _flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, B * 131 + S, cuda_device)
    want, want_lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    before = mod.launches
    got = mod.flash_attention_cuda(q, k, v, causal=causal, window=window)
    with_lse, lse = mod.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert mod.launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    # bf16: outputs round at 2^-8 and P enters P V with ~16 bits (hi + lo
    # halves); f32: the kernel sums in another order than the plain version
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    # the log-sum-exp is one more store: the output keeps its bits
    assert torch.equal(with_lse, got)
    # the LSE's error is the f32 row sum's (another order; ex2.approx on the
    # wgmma path, relative ~2^-22 a term): 1e-4 absolute at |lse| <= ~20;
    # +inf where the row keeps no key, as in the plain version
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D,window", [(128, 0), (64, 100), (256, 128)])
def test_flash_kernel_reads_projection_views_without_copy(cuda_device, D, window):
    """q, k and v as ``_project_qkv`` gives them (transposed views of one
    [B, S, H*D] projection each) go straight to the TMA: the result equals the
    same tensors made contiguous, and two launches give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda as mod

    B, S, Hq, Hkv = 2, 520, 8, 2
    rng = np.random.default_rng(7)
    views = []
    for H in (Hq, Hkv, Hkv):
        x = torch.from_numpy(rng.standard_normal((B, S, H * D), dtype=np.float32))
        x = x.to(device=cuda_device, dtype=torch.bfloat16)
        views.append(x.view(B, S, H, D).transpose(1, 2))
    q, k, v = views
    assert not q.is_contiguous()
    got = mod.flash_attention_cuda(q, k, v, causal=True, window=window)
    again = mod.flash_attention_cuda(q, k, v, causal=True, window=window)
    want = mod.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                    window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_dispatches_cuda_tensors_to_the_kernel(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_cuda as mod

    q, k, v = _flash_inputs(1, 4, 2, 64, 64, 64, torch.float32, 0, cuda_device)
    before = mod.launches
    got = flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)  # strided q
    assert mod.launches == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=0, atol=2e-5)
    # bf16 rows that do not start on 16 bytes are copied for the tensor-core path
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    qs = shifted[1:].view(qb.shape).copy_(qb)
    torch.testing.assert_close(mod.flash_attention_cuda(qs, kb, vb),
                               mod.flash_attention_cuda(qb, kb, vb), rtol=0, atol=0)
    with pytest.raises(TypeError):
        mod.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        mod.flash_attention_cuda(q[..., :48], k[..., :48], v[..., :48])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_smoke_prefill_through_the_kernel_matches_plain(cuda_device, monkeypatch, dtype, tol):
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import flash_attention_cuda as mod
    from repro_torch.models import attention, build_model

    cfg = get_smoke("deepseek-7b").replace(dtype=dtype)
    m = build_model(cfg, device=cuda_device)
    params = m.init(0)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 200)).astype(np.int32))
    batch = {"tokens": tokens.to(cuda_device)}
    before = mod.launches
    got, _ = m.prefill(params, batch, m.init_cache(2, 208))
    assert mod.launches == before + cfg.n_layers
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, **kw: chunked_attention(q, k, v, chunk=64, **kw))
    want, _ = m.prefill(params, batch, m.init_cache(2, 208))
    assert mod.launches == before + cfg.n_layers
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err
