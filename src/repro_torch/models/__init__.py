"""LM workload layer: the dense decoder family and its serving path."""
from .config import ModelConfig  # noqa: F401
from .model import Model, build_model, param_count  # noqa: F401
