"""Calibration on the card against the CPU, and the segment sum's backward.
Marked ``cuda``: they skip where no GPU is present.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_calibration_cuda.py

Exact: the segment sum's gradient on the card against the plain version's
(``index_add_`` forward, autograd backward), at the engine shape, at S*S + 1
= 90001 segments, with lanes; one engine population call of 3 lanes on the
card against the CPU.  ``calibrate_platform(method="grad")`` on the card
against its CPU run: rtol 1e-5 on the loss curve and the params (``exp``,
``log`` and the Adam schedule run in float32 on both, in the same order).
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.calibration as TC  # noqa: E402
from repro_torch.core.engine import _tree_map  # noqa: E402
from repro_torch.kernels.segment_sum import ops as segsum_ops  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _grad(fn, values, seg, n, w):
    v = values.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((fn(v, seg, n) * w).sum(), v)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("J,S,F", [(100_000, 300, 1), (100_000, 90_001, 1), (10_007, 37, 3),
                                   (0, 5, 1)])
def test_segment_sum_backward_equals_plain(cuda_device, J, S, F):
    gen = torch.Generator().manual_seed(J + S + F)
    values = torch.rand((J, F) if F > 1 else (J,), generator=gen).to(cuda_device)
    seg = torch.randint(-3, S + 3, (J,), generator=gen, dtype=torch.int32).to(cuda_device)
    w = torch.randn((S,) + values.shape[1:], generator=gen).to(cuda_device)
    segsum_mod.launches = segsum_ops.backward_launches = 0
    got = _grad(segment_sum, values, seg, S, w)
    assert segsum_mod.launches == 1 and segsum_ops.backward_launches == 1
    assert torch.equal(got, _grad(segment_sum_ref, values, seg, S, w))


@pytest.mark.cuda
def test_segment_sum_backward_lanes_and_no_grad(cuda_device):
    values = torch.rand(3, 5000, device=cuda_device)
    seg = torch.randint(-2, 40, (3, 5000), device=cuda_device, dtype=torch.int32)
    w = torch.randn(3, 37, device=cuda_device)

    def per_lane(v, s, n):
        return torch.stack([segment_sum_ref(v[i], s[i], n) for i in range(3)])

    assert torch.equal(_grad(segment_sum, values, seg, 37, w), _grad(per_lane, values, seg, 37, w))
    segsum_ops.backward_launches = 0
    with torch.no_grad():
        out = segment_sum(values.clone().requires_grad_(True), seg, 37)
    assert not out.requires_grad and segsum_ops.backward_launches == 0
    assert not segment_sum(values, seg, 37).requires_grad   # no gradient asked: the kernel alone


@pytest.fixture(scope="module")
def problem_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    card, truth = TC.make_synthetic_platform_problem(n_jobs=60, n_sites=4, seed=3,
                                                     trace="engine", wan_frac=0.5,
                                                     max_rounds=6000, device="cuda")
    return card, _tree_map(lambda x: x.cpu(), card)


@pytest.mark.cuda
def test_calibrate_platform_grad_card_equals_cpu(problem_pair):
    card, cpu = problem_pair
    segsum_ops.backward_launches = 0
    kw = dict(method="grad", n_iters=30, lr=0.1, seed=1)
    a = TC.calibrate_platform(card, **kw)
    assert segsum_ops.backward_launches > 0   # the backward ran on the card
    b = TC.calibrate_platform(cpu, **kw)
    torch.testing.assert_close(a.history.cpu(), b.history, rtol=1e-5, atol=0.0)
    for f in TC.PARAM_FIELDS:
        torch.testing.assert_close(getattr(a.params, f).cpu(), getattr(b.params, f),
                                   rtol=1e-5, atol=0.0)
    assert float(a.err) < float(a.err0)


@pytest.mark.cuda
def test_engine_population_card_equals_cpu(problem_pair):
    card, cpu = problem_pair
    be_card = TC.make_population_objective(card, objective="engine", max_rounds=6000)
    be_cpu = TC.make_population_objective(cpu, objective="engine", max_rounds=6000)
    z = be_cpu.z0[None, :] + 0.3 * torch.randn(3, be_cpu.z0.shape[0],
                                                generator=torch.Generator().manual_seed(0))
    segsum_mod.launches = 0
    lanes = be_card(z.cuda())
    assert segsum_mod.launches > 0
    assert torch.equal(lanes.cpu(), be_cpu(z))
