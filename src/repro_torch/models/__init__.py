"""LM workload layer: every architecture family of the registry (dense, MoE,
SSM, hybrid, encoder-decoder, VLM) and its serving path."""
from .config import ModelConfig  # noqa: F401
from .model import Model, build_model, param_count  # noqa: F401
