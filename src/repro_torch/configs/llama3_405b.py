"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    mlp_act="swiglu",
    vocab_size=128256,
    rope_theta=5e5,
)

SMOKE = CONFIG.replace(
    name="llama3-smoke", n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=384, vocab_size=512,
)

PLANS = {
    # 1 seq per DP shard per microbatch; SP-lite shards the residual stream's
    # seq dim over 'model' at scan boundaries -> ~1 GB of saved activations
    "train_4k": CellPlan(microbatches=8, seq_shard=True),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
