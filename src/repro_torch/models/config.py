"""Model configuration shared by every architecture in the pool.

The same fields as the JAX package's ``ModelConfig``, so a configuration
carries across unchanged.  On one device the port ignores the mesh and
compile fields (``seq_shard``, ``explicit_fsdp_gather``, ``remat``): layers
run in a Python loop over an ``nn.ModuleList``.  ``router_groups`` splits the
MoE router's tokens into independent problems, and ``scan_layers`` picks the
router's row block as in the reference (256 rows, or one group's tokens when
it is False).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # attention (ignored by pure-SSM layers)
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                # sliding-window size for local attention
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu | relu2
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_groups: int = 1         # independent routing groups (= DP shards)
    # ssm (mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (griffin/recurrentgemma)
    block_pattern: tuple = ()      # e.g. ("rec", "rec", "att") repeated
    rnn_width: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    n_frames: int = 1500           # encoder positions fed by the audio stub
    # vlm
    n_patches: int = 0             # patch embeddings spliced over the prefix
    # parallelism
    seq_shard: bool = False        # SP-lite: shard residual seq over 'model'
                                   # at scan boundaries (set by the cell plan)
    explicit_fsdp_gather: bool = True  # materialize the ZeRO-3 gather per
                                   # layer with TP sharding preserved
    scan_layers: bool = True       # lax.scan over stacked layers (HLO size
                                   # depth-independent); False unrolls, which
                                   # the roofline pass uses for exact per-op
                                   # cost_analysis (scan bodies count once)
    # numerics / structure
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True
    attn_chunk: int = 512          # KV chunk for the scanned attention
    attention_impl: str = "chunked"  # chunked | qblock (flash schedule)
    attn_q_block: int = 1024       # q tile for attention_impl=qblock
    notes: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ---- parameter / flop accounting (roofline MODEL_FLOPS) -----------------

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            qd = self.n_heads * self.d_head
            kd = self.n_kv_heads * self.d_head
            return d * qd + 2 * d * kd + qd * d

        def mlp_params(ff):
            mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            return mats * d * ff

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(self.d_ff)
            layers = self.n_layers
        elif self.family == "moe":
            per_layer = attn_params() + self.n_experts * mlp_params(self.d_ff) + d * self.n_experts
            layers = self.n_layers
        elif self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            conv_ch = di + 2 * self.ssm_groups * ns
            per_layer = (
                d * (2 * di + 2 * self.ssm_groups * ns + self.n_ssm_heads)
                + conv_ch * self.ssm_conv
                + di * d
            )
            layers = self.n_layers
        elif self.family == "hybrid":
            rec = 2 * d * self.rnn_width + self.rnn_width * d + 3 * self.rnn_width
            att = attn_params()
            pattern = self.block_pattern or ("rec",)
            n_rec = sum(1 for i in range(self.n_layers) if pattern[i % len(pattern)] == "rec")
            n_att = self.n_layers - n_rec
            per_layer = 0
            layers = 1
            per_layer = n_rec * (rec + mlp_params(self.d_ff)) + n_att * (att + mlp_params(self.d_ff))
        elif self.family == "encdec":
            enc = attn_params() + mlp_params(self.d_ff)
            dec = 2 * attn_params() + mlp_params(self.d_ff)
            per_layer = 0
            layers = 1
            per_layer = self.n_enc_layers * enc + self.n_dec_layers * dec
        return emb + layers * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        dense = self.param_count() - self.n_layers * self.n_experts * mats * d * self.d_ff
        return dense + self.n_layers * self.top_k * mats * d * self.d_ff

    def model_flops_per_token(self, *, backward: bool = True) -> float:
        """6*N_active (train) or 2*N_active (inference) per token."""
        n = self.active_param_count()
        return (6.0 if backward else 2.0) * n
