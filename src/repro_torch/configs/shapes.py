"""Assigned input shapes, one set shared by the LM-family pool.

The JAX package's per-(arch x shape) mesh plans (``CellPlan``) come with the
port of ``launch/``: on one card there is no mesh to plan.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
