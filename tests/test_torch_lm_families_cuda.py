"""The MoE, SSM and hybrid LM families on the card against the port on the
CPU.  Marked ``cuda``: they skip where no GPU is present.  This file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_families_cuda.py

``moe_route`` through the assignment kernel is held against its plain
version on the card at granite-moe's and kimi-k2's routing shapes (the
prefill of 4 x 4096 tokens in 32 groups, and a decode step's one group) and
on both sides of each form boundary of the kernel (row blocks of 256 and of
the whole group, groups not a multiple of the tile, k = 1, groups too large
for one cluster): ``idx``, ``slot`` and ``keep`` exactly, ``combine`` within
1e-6, and the same bits on two calls.  One block
of each kind (``att``, ``moe``, ``ssm``, ``rec``) of the smoke configs, in
float32 and on the same weights and inputs, is held to the CPU port within
1e-4; the blocks with attention launch the flash kernel and the MoE block
the assignment kernel, once each.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.moe import moe_capacity  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


GRANITE, KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
# (arch, G, Tg, block_n, k, form): k None is the config's top_k; the form is
# the one the assign kernel takes for [G, Tg, E] (a cluster of at most 8
# tiles a group, else 64-row tiles and three launches, or at k = 1 past
# 1024 rows the engine's three-pass form)
ROUTE_CASES = [
    (GRANITE, 32, 512, 256, None, "cluster"),   # granite's prefill: 8 tiles of 64 rows a group
    (GRANITE, 1, 4, 256, None, "cluster"),      # a decode step: one CTA
    (KIMI, 32, 512, 256, None, "cluster"),
    (KIMI, 1, 4, 256, None, "cluster"),
    (GRANITE, 1, 512, 512, None, "cluster"),    # block_n = Tg: one row block
    (KIMI, 32, 512, 512, None, "cluster"),
    (GRANITE, 4, 520, 256, None, "cluster"),    # Tg not a multiple of the tile: 128-row tiles
    (GRANITE, 4, 600, 256, None, "cluster"),
    (KIMI, 2, 600, 600, None, "cluster"),
    (GRANITE, 32, 512, 256, 1, "cluster"),      # k = 1 at a routing shape
    (GRANITE, 2, 4096, 256, None, "tiles"),     # a group too large for one cluster
    (KIMI, 2, 2000, 256, None, "tiles"),
    (GRANITE, 1, 4096, 4096, 1, "rows"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,G,Tg,block_n,k,form", ROUTE_CASES)
def test_moe_route_kernel_matches_plain(cuda_device, arch, G, Tg, block_n, k, form):
    from repro_torch.kernels.assign import assign_cuda as mod
    from repro_torch.kernels.assign.ops import moe_route, moe_route_ref

    cfg = get_config(arch)
    cfg = cfg.replace(top_k=k or cfg.top_k)
    E = cfg.n_experts
    assert mod.plan(G, Tg, E, cfg.top_k, block_n)["form"] == form
    gen = torch.Generator(device=cuda_device).manual_seed(G + E + Tg)
    # a router that favours the later experts, so that the capacity binds
    skew = torch.linspace(0.0, 1.0, E, device=cuda_device)
    logits = torch.randn((G, Tg, E), generator=gen, device=cuda_device) * 0.5 + skew
    kw = dict(k=cfg.top_k, capacity=moe_capacity(cfg, Tg), block_n=block_n)
    before = mod.launches
    got = moe_route(logits, **kw)
    assert mod.launches == before + 1
    want = moe_route_ref(logits, **kw)
    assert mod.launches == before + 1, "the plain route launched the kernel"
    for i in (0, 2, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    again = moe_route(logits, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two calls differ"
    if G > 1:
        assert not bool(got[3].all()), "the capacity must drop some slots"


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("deepseek-7b", "att"), ("granite-moe-1b-a400m", "moe"),
                                       ("mamba2-130m", "ssm"), ("recurrentgemma-2b", "rec"),
                                       ("recurrentgemma-2b", "att")])
def test_block_on_card_matches_cpu(cuda_device, arch, kind):
    from repro_torch.kernels.assign import assign_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = get_smoke(arch).replace(dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(3)
    block = transformer.init_block(gen, cfg, kind, torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 48, cfg.d_model)).astype(
        np.float32))
    want, want_aux = transformer.block_train(block, x, cfg)
    card = copy.deepcopy(block).to(cuda_device)
    counts = (assign_cuda.launches, flash_attention_cuda.launches)
    got, got_aux = transformer.block_train(card, x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert assign_cuda.launches - counts[0] == (kind == "moe")
    assert flash_attention_cuda.launches - counts[1] == (kind in ("att", "moe"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    if kind == "moe":
        for k, v in want_aux.items():
            torch.testing.assert_close(got_aux[k].cpu(), v, rtol=1e-4, atol=1e-5)
