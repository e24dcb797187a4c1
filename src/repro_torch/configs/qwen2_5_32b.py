"""qwen2.5-32b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-*].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    qkv_bias=True,
    d_ff=27648,
    mlp_act="swiglu",
    vocab_size=152064,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=256, vocab_size=512,
)

PLANS = {
    "train_4k": CellPlan(microbatches=4),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
