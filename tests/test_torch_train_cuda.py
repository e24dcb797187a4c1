"""The training path's backward kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``: they skip where no GPU is present.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: the flash backward's dq, dk and dv within 1e-4 (float32) or
2^-6 (bfloat16) of each row's largest gradient (at least 1e-2 of the
tensor's largest: the first causal row's dq is zero up to rounding), against
the plain version ``attention_bwd_ref`` given the same log-sum-exp (the
kernel sums in another order, and rounds P and dS to bf16 once for the
products that take them;
bf16 gradients round at 2^-8), and in float32 within 5e-4 against autograd
through ``attention_ref`` (``dO V^T - rowsum(dO * O)`` cancels in rows that
see few keys; ``tests/test_torch_train.py`` holds the plain version to
finite differences in f64).  (In bf16 both the kernel and its plain version take
``rowsum(dO * O)`` from the forward's bf16 output, as a flash backward does,
where autograd keeps O in f32; in rows whose ``dO V^T`` nearly cancels that
rowsum, dq moves by several percent of the row's largest.)  The gate backward
within 1e-6 of each row's largest entry against its plain version (``expf``
against ``torch.exp``, the order of the sums), and within 2e-6 against
autograd through ``assign_ref``, whose softmax gradient also runs through
the row max and rounds elsewhere.  Both kernels give the same bits on every
run.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.assign import ops as assign_ops  # noqa: E402
from repro_torch.kernels.assign import gate_backward_cuda as gate_mod  # noqa: E402
from repro_torch.kernels.assign.gate_backward_cuda import gate_backward_cuda  # noqa: E402
from repro_torch.kernels.assign.ref import assign_ref, gate_backward_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda as bwd_mod  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention_bwd_cuda import (  # noqa: E402
    flash_attention_backward_cuda,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

BWD_CASES = [
    # (B, Hq, Hkv, S, Skv, D, causal, window, dtype)
    (1, 2, 2, 64, 64, 64, True, 0, "float32"),
    (2, 4, 2, 100, 100, 32, True, 0, "float32"),      # ragged tiles, GQA 2
    (1, 8, 1, 77, 77, 128, True, 16, "float32"),      # a window, MQA 8
    (1, 2, 2, 50, 130, 64, False, 0, "float32"),      # non-causal, Skv % 64 != 0
    (1, 2, 1, 40, 90, 16, True, 0, "float32"),        # q right-aligned (Skv > S)
    (1, 2, 2, 96, 96, 256, True, 40, "float32"),      # D = 256, 32-row tiles
    (1, 2, 2, 70, 70, 192, False, 0, "float32"),
    (1, 2, 2, 65, 65, 96, True, 0, "float32"),
    (2, 16, 8, 256, 256, 64, True, 0, "bfloat16"),    # granite's heads
    (1, 4, 4, 200, 200, 128, True, 0, "bfloat16"),
    (1, 10, 1, 300, 300, 256, True, 128, "bfloat16"),  # recurrentgemma's heads and window
    (2, 12, 12, 150, 150, 64, False, 0, "bfloat16"),  # whisper's encoder heads
    (1, 4, 2, 100, 100, 32, True, 0, "bfloat16"),     # the tensor-core path at D = 32
    (1, 2, 2, 70, 130, 96, False, 0, "bfloat16"),     # D = 96, Skv % 64 != 0, right-aligned
    (1, 4, 4, 65, 65, 16, True, 8, "bfloat16"),       # D = 16, a window
    (1, 2, 2, 96, 96, 192, True, 0, "bfloat16"),      # D = 192: the CUDA-core path in bf16
    # the wgmma/TMA path at each of its widths: ragged 64-row tiles (Skv not a
    # multiple of 64), right-aligned q (S < Skv), a window; more queries than
    # keys under causality (the first rows keep no key)
    (1, 4, 2, 130, 130, 64, True, 0, "bfloat16"),
    (1, 4, 2, 70, 1000, 64, True, 0, "bfloat16"),
    (1, 2, 2, 100, 60, 64, True, 0, "bfloat16"),
    (1, 2, 2, 700, 700, 128, True, 0, "bfloat16"),
    (1, 4, 1, 100, 130, 128, False, 0, "bfloat16"),
    (1, 2, 1, 130, 130, 256, True, 0, "bfloat16"),
    (1, 2, 2, 100, 700, 256, True, 64, "bfloat16"),
    (2, 4, 4, 200, 200, 256, False, 0, "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _attention_inputs(B, Hq, Hkv, S, Skv, D, dtype, seed, device):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, S, D))
    return tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                 .to(device=device, dtype=getattr(torch, dtype)) for sh in shapes)


def row_error(got, want) -> float:
    """The largest error of a row over that row's largest magnitude (at
    least 1e-2 of the whole tensor's: a row whose gradient is zero in exact
    arithmetic, such as the first causal row's dq, holds rounding only)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(1e-2 * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_matches_plain(cuda_device, case):
    B, Hq, Hkv, S, Skv, D, causal, window, dtype = case
    q, k, v, do = _attention_inputs(B, Hq, Hkv, S, Skv, D, dtype, S + D, cuda_device)
    o, lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    got = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window)
    again = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window)
    plain = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, lse=lse)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(out, leaves, do.float())
    torch.cuda.synchronize()
    for name, g, p, a, g2 in zip("qkv", got, plain, auto, again):
        assert g.dtype == getattr(torch, dtype) and g.shape == p.shape
        assert torch.equal(g, g2), f"d{name} differs between two runs"
        assert row_error(g, p) <= TOL[dtype], (name, row_error(g, p))
        if dtype == "float32":
            assert row_error(g, a) <= 5e-4, (name, row_error(g, a))


@pytest.mark.cuda
def test_flash_autograd_launches_backward_kernel(cuda_device):
    """``flash_attention`` on inputs that require grad runs the forward
    kernel once and, in backward, the backward kernel once; strided views
    (the projections' transposes) are taken as they are."""
    B, S, H, D = 2, 128, 4, 64
    x = torch.randn(B, S, 3 * H * D, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in x.split(H * D, dim=-1))
    before = bwd_mod.launches
    o = flash_attention(q, k, v, causal=True)
    (gx,) = torch.autograd.grad(o.float().square().sum(), x)
    assert bwd_mod.launches == before + 1
    xr = x.detach().float().requires_grad_(True)
    qr, kr, vr = (t.view(B, S, H, D).transpose(1, 2) for t in xr.split(H * D, dim=-1))
    (want,) = torch.autograd.grad(attention_ref(qr, kr, vr).square().sum(), xr)
    assert row_error(gx, want) <= 2.0 ** -5   # bf16 output rounded before the square
    with torch.no_grad():
        flash_attention(q, k, v)
    assert bwd_mod.launches == before + 1


@pytest.mark.cuda
def test_flash_backward_copies_unaligned_rows(cuda_device):
    """A bf16 view whose rows do not start on 16 bytes (an odd element
    offset) takes the tensor-core path after a copy, with the same result."""
    q, k, v, do = _attention_inputs(1, 2, 2, 64, 64, 64, "bfloat16", 1, cuda_device)
    base = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = base[1:].view(q.shape)
    shifted.copy_(q)
    o, lse = attention_ref(q, k, v, return_lse=True)
    want = flash_attention_backward_cuda(q, k, v, o, do, lse)
    got = flash_attention_backward_cuda(shifted, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_flash_backward_raises_on_bad_inputs(cuda_device):
    q, k, v, do = _attention_inputs(1, 2, 2, 64, 64, 64, "float32", 0, cuda_device)
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(TypeError):
        flash_attention_backward_cuda(q.half(), k.half(), v.half(), o.half(), do.half(), lse)
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q.cpu(), k, v, o, do, lse)
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, k, v, o[:, :, :10], do, lse)
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, k, v, o, do, lse[:, :, :10])
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, k, v, o, do, lse.double())
    q, k, v, do = _attention_inputs(1, 2, 2, 64, 64, 48, "float32", 0, cuda_device)
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, k, v, o, do, lse)


def _gate_inputs(lanes, N, E, k, seed, device):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(*lanes, N, E)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.2] = -1e30
    scores[..., 3, :] = -1e30                    # a row without a feasible bin
    scores = torch.from_numpy(scores).to(device)
    sizes = torch.ones((*lanes, N), device=device)
    caps = torch.full((*lanes, E), max(1.0, N * k / E * 0.6), device=device)  # drops
    idx, gate, admit, pos = assign_ref(scores, sizes, caps, k=k, block_n=N)
    dgate = torch.from_numpy(rng.normal(size=tuple(gate.shape)).astype(np.float32)).to(device)
    return scores, sizes, caps, idx, dgate


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,N,E,k", [
    ((), 64, 8, 1), ((), 100, 7, 2), ((32,), 512, 32, 8), ((4,), 128, 384, 8), ((), 50, 512, 3),
    # a lane's values matched to E: 1 (E <= 32), 2, the 16-byte forms; rows
    # not a multiple of a CTA's; k > E (slots past the bins are -1)
    ((), 37, 1, 1), ((), 50, 1, 3), ((3,), 77, 31, 8), ((), 301, 33, 8), ((2,), 129, 512, 8),
    ((), 45, 5, 7), ((), 1001, 64, 2), ((5,), 203, 260, 40),
])
def test_gate_backward_matches_plain(cuda_device, lanes, N, E, k):
    scores, sizes, caps, idx, dgate = _gate_inputs(lanes, N, E, k, N + E, cuda_device)
    got = gate_backward_cuda(scores, idx, dgate)
    again = gate_backward_cuda(scores, idx, dgate)
    want = gate_backward_ref(scores, idx, dgate)
    leaf = scores.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad((assign_ref(leaf, sizes, caps, k=k, block_n=N)[1] * dgate)
                                  .sum(), leaf)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert row_error(got, want) <= 1e-6
    assert row_error(got, auto) <= 2e-6
    assert bool((got[..., 3, :] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("E,k", [(7, 8), (100, 8), (384, 8), (384, 40)])
def test_gate_backward_repeated_and_stray_picks(cuda_device, E, k):
    """Picks the assignment never makes but the contract takes: one bin in
    several slots (their gradients add in slot order), -1, and bins past E
    (they add nothing), on the shuffle path (E <= 64) and the table path."""
    rng = np.random.default_rng(E + k)
    scores = torch.from_numpy(rng.normal(size=(3, 50, E)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(-1, E + 2, size=(3, 50, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]                  # every row repeats a bin
    idx = torch.from_numpy(idx).to(cuda_device)
    dgate = torch.from_numpy(rng.normal(size=(3, 50, k)).astype(np.float32)).to(cuda_device)
    got = gate_backward_cuda(scores, idx, dgate)
    want = gate_backward_ref(scores, idx, dgate)
    torch.cuda.synchronize()
    assert torch.equal(got, gate_backward_cuda(scores, idx, dgate))
    assert row_error(got, want) <= 1e-6


@pytest.mark.cuda
def test_route_gradient_through_kernels(cuda_device):
    """``moe_route`` on logits that require grad launches the assign kernel
    and, in backward, the gate kernel; the gradient equals the plain route's."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(4, 256, 32)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(4, 256, 8)).astype(np.float32)).to(cuda_device)
    grads = []
    for route in (assign_ops.moe_route, assign_ops.moe_route_ref):
        leaf = logits.clone().requires_grad_(True)
        before = gate_mod.launches
        combine = route(leaf, k=8, capacity=80, block_n=256)[1]
        (g,) = torch.autograd.grad((combine * w).sum(), leaf)
        grads.append(g)
        assert gate_mod.launches == before + (route is assign_ops.moe_route)
    assert row_error(grads[0], grads[1]) <= 2e-6


@pytest.mark.cuda
def test_gate_backward_raises_on_bad_inputs(cuda_device):
    scores, _, _, idx, dgate = _gate_inputs((), 64, 8, 2, 0, cuda_device)
    with pytest.raises(TypeError):
        gate_backward_cuda(scores.double(), idx, dgate)
    with pytest.raises(ValueError):
        gate_backward_cuda(scores.cpu(), idx, dgate)
    with pytest.raises(ValueError):
        gate_backward_cuda(scores, idx[:, :1], dgate)
    wide = torch.zeros(4, 600, device=cuda_device)
    with pytest.raises(ValueError):
        gate_backward_cuda(wide, torch.zeros(4, 1, dtype=torch.int32, device=cuda_device),
                           torch.zeros(4, 1, device=cuda_device))
