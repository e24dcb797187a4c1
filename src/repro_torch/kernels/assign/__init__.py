"""Capacity-constrained greedy assignment (jobs x sites, tokens x experts)."""
from .ops import assign, make_capacity_assign  # noqa: F401
from .ref import assign_ref  # noqa: F401
