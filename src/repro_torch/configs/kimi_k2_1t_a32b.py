"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE.

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048, 384 experts top-8,
vocab=163840.  ~1.04T parameters, ~32B active per token.  Token->expert
capacity routing is the simulator's assignment problem and runs the same
assignment kernel.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    mlp_act="swiglu",
    n_experts=384,
    top_k=8,
    capacity_factor=1.25,
    router_groups=32,  # = data-parallel shards on the production mesh
    vocab_size=163840,
)

SMOKE = CONFIG.replace(
    name="kimi-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=64, n_experts=8, top_k=2, router_groups=2, vocab_size=512,
)

PLANS = {
    "train_4k": CellPlan(microbatches=8, seq_shard=True),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
