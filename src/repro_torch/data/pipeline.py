"""Deterministic synthetic token pipeline, the JAX package's
``data/pipeline.py`` with batches on a torch device.

An infinite, seeded, host-sharded token stream: ``batch_at(step)`` is a pure
function of (seed, step, shard), so a restart resumes bit-identically and
every data-parallel host reads a disjoint shard.  Zipfian token draws with
document boundaries (BOS) and a repeated-bigram structure, so losses fall in
short training runs.  The draws are numpy's, the same as the JAX package's
bit for bit; only the last step (``torch`` int32 on ``device`` instead of a
``jnp`` array) differs.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.types import resolve_device


class DataConfig(NamedTuple):
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    bos_id: int = 1
    mean_doc_len: int = 512
    zipf_a: float = 1.2


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** -cfg.zipf_a
    return (p / p.sum()).astype(np.float64)


class TokenPipeline:
    """Host-side numpy generation, device batches on demand."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._probs = _zipf_probs(cfg)
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> dict:
        """This host's int32 ``tokens [local_batch, seq_len]`` of ``step`` on
        the pipeline's device."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        B, S = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S), p=self._probs)
        # structure: periodic bigram echo (learnable signal)
        toks[:, 2::2] = toks[:, 1:-1:2]
        # document boundaries
        n_docs = max(1, S // cfg.mean_doc_len)
        for b in range(B):
            cuts = rng.choice(S, size=n_docs, replace=False)
            toks[b, cuts] = cfg.bos_id
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Thread-backed prefetcher overlapping host generation with the device step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
