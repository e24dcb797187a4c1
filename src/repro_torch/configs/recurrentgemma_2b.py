"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2 [arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000, window=2048.
Griffin pattern: (rec, rec, att) repeating -> 8 full groups + 2 recurrent.
Decode only ever reads the last ``window`` positions, so a cache of
``window`` slots is a rolling buffer (the ``long_500k`` plan's
``decode_cache_len=2048``).
"""
from ..models.config import ModelConfig
from .shapes import CellPlan

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    mlp_act="geglu",
    vocab_size=256000,
    window=2048,
    block_pattern=("rec", "rec", "att"),
    rnn_width=2560,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=1, d_head=32, d_ff=256, vocab_size=512, window=32,
    block_pattern=("rec", "rec", "att"), rnn_width=128,
)

PLANS = {
    "train_4k": CellPlan(microbatches=2),
    "prefill_32k": CellPlan(),
    "decode_32k": CellPlan(),
    # decode only ever touches the last `window` positions: rolling cache
    "long_500k": CellPlan(decode_cache_len=2048,
                          notes="window-bounded rolling KV + O(1) LRU state"),
}
SKIPS: dict[str, str] = {}
