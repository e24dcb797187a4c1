"""Causal / sliding-window GQA attention: the flash kernel for CUDA tensors,
plain PyTorch forms for CPU tensors, and the decode-step attention."""
from .ops import (  # noqa: F401
    chunked_attention,
    decode_attention,
    flash_attention,
    qblock_attention,
)
from .ref import attention_ref  # noqa: F401
