"""Per-segment sums in row order (the engine's deterministic scatter-add)."""
from .ops import segment_sum, segment_sum_ref  # noqa: F401
