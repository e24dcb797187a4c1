"""The synthetic token pipeline that feeds training."""
from .pipeline import DataConfig, TokenPipeline, prefetch  # noqa: F401
