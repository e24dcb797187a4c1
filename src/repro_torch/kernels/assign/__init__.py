"""Capacity-constrained greedy assignment (jobs x sites, tokens x experts),
dense and over sparse candidate sets."""
from .fused_ref import fused_assign_ref  # noqa: F401
from .ops import (  # noqa: F401
    assign,
    block_admit,
    block_claims,
    fused_topk_assign,
    make_capacity_assign,
    make_fused_capacity_assign,
    moe_route,
    moe_route_ref,
)
from .ref import assign_ref  # noqa: F401
