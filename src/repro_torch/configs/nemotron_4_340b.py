"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    mlp_act="relu2",
    vocab_size=256000,
)

SMOKE = CONFIG.replace(
    name="nemotron-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=256, vocab_size=512,
)

PLANS = {
    "train_4k": CellPlan(microbatches=8, seq_shard=True),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
