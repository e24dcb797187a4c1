"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) expert d_ff=512, 32e top-8, vocab=49155.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    mlp_act="swiglu",
    n_experts=32,
    top_k=8,
    capacity_factor=1.25,
    router_groups=32,
    vocab_size=49155,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=64, n_experts=4, top_k=2, router_groups=2, vocab_size=512,
)

PLANS = {
    "train_4k": CellPlan(microbatches=1),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
