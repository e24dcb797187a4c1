"""The hand-written kernels as custom ops, and the counter, on the card.
Marked ``cuda``: they skip where no GPU is present.  This file imports no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_launch_cuda.py

Each custom op (``repro_torch::flash_fwd``, ``flash_bwd``, ``assign``,
``gate_backward``) given CUDA tensors gives the bits its kernel's wrapper
gives (the op calls the same wrapper), and a CPU tensor never reaches a
kernel.  A smoke model's train step counted on the card has the FLOPs of
the same step traced on meta tensors, exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign.assign_cuda import assign_cuda  # noqa: E402
from repro_torch.kernels.assign.gate_backward_cuda import gate_backward_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention_bwd_cuda import (  # noqa: E402
    flash_attention_backward_cuda,
)
from repro_torch.kernels.flash_attention.flash_attention_cuda import (  # noqa: E402
    flash_attention_cuda,
)

ops = torch.ops.repro_torch
pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _normal(shape, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_ops_equal_their_wrappers(causal, window):
    q, k, v = _normal((2, 8, 256, 64), 0), _normal((2, 4, 256, 64), 1), _normal((2, 4, 256, 64), 2)
    o, lse = ops.flash_fwd(q, k, v, causal, window, None, True)
    o_w, lse_w = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    assert torch.equal(o, o_w) and torch.equal(lse, lse_w)
    o2, empty = ops.flash_fwd(q, k, v, causal, window, None, False)
    assert torch.equal(o2, flash_attention_cuda(q, k, v, causal=causal, window=window))
    assert empty.shape == (2, 8, 0)
    do = _normal(o.shape, 3)
    got = ops.flash_bwd(q, k, v, o, do, lse, causal, window, None)
    want = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("G,T,E,k", [(32, 512, 32, 8), (4, 300, 7, 2), (1, 2000, 64, 1)])
def test_assign_ops_equal_their_wrappers(G, T, E, k):
    rng = np.random.default_rng(E)
    scores = torch.from_numpy(rng.normal(size=(G, T, E)).astype(np.float32)).cuda()
    sizes = torch.ones((G, T), device="cuda")
    caps = torch.full((G, E), float(T * k // E + 1), device="cuda")
    before = assign_mod.launches
    got = ops.assign(scores, sizes, caps, k, T)
    assert assign_mod.launches == before + 1
    want = assign_cuda(scores, sizes, caps, k=k, block_n=T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dgate = torch.from_numpy(rng.normal(size=(G, T, k)).astype(np.float32)).cuda()
    assert torch.equal(ops.gate_backward(scores, got[0], dgate),
                       gate_backward_cuda(scores, got[0], dgate))


def test_ops_raise_rather_than_fall_back():
    q = _normal((1, 2, 16, 48), 0)   # D = 48 is compiled into no route
    with pytest.raises(ValueError):
        ops.flash_fwd(q, q, q, True, 0, None, False)
    with pytest.raises((TypeError, ValueError)):
        ops.gate_backward(torch.zeros((2, 4, 8), device="cuda", dtype=torch.float64),
                          torch.zeros((2, 4, 1), device="cuda", dtype=torch.int32),
                          torch.zeros((2, 4, 1), device="cuda", dtype=torch.float64)[..., :0])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-7b"])
def test_card_count_equals_meta_count(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.roofline import Counter
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_smoke(arch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
                              .astype(np.int32))
    flops = {}
    for dev in ("meta", "cuda"):
        model = build_model(cfg, device=dev)
        step = make_train_step(model, AdamWConfig(warmup_steps=1), microbatches=2)
        state = init_train_state(model, 0)
        with Counter(peak=dev == "meta") as c:
            step(state, {"tokens": tokens.to(dev)})
        flops[dev] = c.get_total_flops()
        assert c.ops["repro_torch::flash_fwd"] > 0 and c.ops["repro_torch::flash_bwd"] > 0
    assert flops["cuda"] == flops["meta"] > 0
