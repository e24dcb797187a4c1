"""Assigned input shapes (one set shared by the LM-family pool) and the
per-(arch x shape) execution plan (microbatching, activation sharding)."""
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


@dataclass(frozen=True)
class CellPlan:
    """Per-(arch x shape) parallel execution plan on the production mesh."""

    microbatches: int = 1        # grad-accum steps inside train_step
    seq_shard: bool = False      # shard the residual stream's seq dim over
                                 # 'model' at layer boundaries (SP-lite)
    shard_cache_len: bool = True  # shard KV-cache positions over 'model'
    decode_cache_len: int | None = None  # override cache buffer (e.g. window)
    opt_8bit: bool = False       # block-wise int8 optimizer states
    notes: str = ""


def default_plan(kind: str) -> CellPlan:
    return CellPlan()
