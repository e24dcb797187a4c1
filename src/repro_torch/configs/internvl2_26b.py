"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone only: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The
vision frontend is a stub: ``patch_embeds [B, 256, d_model]`` are spliced
over the first token positions.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    mlp_act="swiglu",
    vocab_size=92553,
    n_patches=256,
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=256, vocab_size=512, n_patches=8,
)

PLANS = {
    "train_4k": CellPlan(microbatches=4),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "pure full attention (quadratic); no sub-quadratic path"}
