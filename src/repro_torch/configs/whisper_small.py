"""whisper-small [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768 12H d_ff=3072 vocab=51865.  The
mel + conv frontend is a stub: ``frames [B, 1500, d_model]`` arrive as
precomputed frame embeddings.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    qkv_bias=True,
    d_ff=3072,
    mlp_act="gelu",
    vocab_size=51865,
    n_frames=1500,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
    vocab_size=512, n_frames=32,
)

PLANS = {
    "train_4k": CellPlan(microbatches=1),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
}
SKIPS = {"long_500k": "full-attention enc-dec; no sub-quadratic path"}
