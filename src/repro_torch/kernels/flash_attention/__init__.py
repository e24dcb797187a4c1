"""Causal / sliding-window GQA attention: the flash kernel for CUDA tensors,
plain PyTorch forms for CPU tensors, and the decode-step attention."""
from .ops import (  # noqa: F401
    attention_live_pairs,
    chunked_attention,
    decode_attention,
    flash_attention,
    flash_attention_backward,
    flash_flops,
    qblock_attention,
)
from .ref import attention_bwd_ref, attention_ref  # noqa: F401
