"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    mlp_act="swiglu",
    vocab_size=102400,
)

SMOKE = CONFIG.replace(
    name="deepseek-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_head=32, d_ff=256, vocab_size=512,
)

PLANS = {
    "train_4k": CellPlan(microbatches=4),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
