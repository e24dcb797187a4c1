"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 (attention-free), vocab=50280, ssm_state=128.
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50280,
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    notes="pure SSM; sub-quadratic -> runs long_500k",
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke", n_layers=2, d_model=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
)

PLANS = {
    "train_4k": CellPlan(microbatches=1),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
    "long_500k": CellPlan(notes="constant-size SSM state; cache is O(1)"),
}
SKIPS: dict[str, str] = {}
