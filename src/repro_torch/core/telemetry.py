"""Flight recorder: run telemetry, manifests and streaming sinks.

The JAX package's observability layer, on PyTorch:

- ``TraceRecorder``: host-side named wall-clock spans, counters and notes
  (``with rec.span("execute"): ...``).  A span costs two ``perf_counter``
  calls and a dict update, and every instrumentation site in the engine is
  guarded by ``recorder is not None``, so a run without one pays nothing.
- ``Sink``: a streaming-record protocol (``emit(dict)``/``close()``) with
  NDJSON-file, in-memory and callback sinks.  Monitor frames and telemetry
  spans stream through sinks, so export memory is bounded per record.
- The run manifest: a self-describing sidecar JSON
  (``<artifact>.manifest.json``) recording the environment (the torch
  version, CUDA version, backend, device count and device names; package
  versions), the scenario's content hash, the subsystems and the recorder's
  wall-clock breakdown.  ``manifest_drift`` diffs two manifests'
  environment blocks: a change of environment explains a change of speed.

- ``lane_occupancy``: per-lane occupancy of an ensemble's result (rounds,
  the lock-step share, padding, the phase-skip guard's hit rate).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

MANIFEST_SCHEMA = "cgsim.run_manifest/v1"
MANIFEST_SUFFIX = ".manifest.json"


# --------------------------------------------------------------------------
# sinks: streaming record consumers
# --------------------------------------------------------------------------


@runtime_checkable
class Sink(Protocol):
    """Anything that accepts a stream of JSON-able record dicts."""

    def emit(self, record: dict) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Drops every record."""

    def emit(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """Collects records in a list (tests, notebooks, small runs)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass

    def __len__(self) -> int:
        return len(self.records)


class CallbackSink:
    """Forwards each record to a callable (a dashboard push, a queue)."""

    def __init__(self, fn: Callable[[dict], None]):
        self.fn = fn

    def emit(self, record: dict) -> None:
        self.fn(record)

    def close(self) -> None:
        pass


class NDJSONSink:
    """Streams records as newline-delimited JSON, one object a line.

    Takes a path (opened and owned here) or anything with ``.write()``.  A
    record is flushed every ``flush_every`` emits, so another process can
    tail the file live (``python -m repro_torch.monitor --follow run.ndjson``).
    """

    def __init__(self, target, *, flush_every: int = 1):
        if hasattr(target, "write"):
            self._f, self._owns = target, False
        else:
            self.path = pathlib.Path(target)
            self._f, self._owns = open(self.path, "w"), True
        self._flush_every = max(int(flush_every), 1)
        self._n = 0

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_ndjson(source, *, follow: bool = False, poll_s: float = 0.2,
                timeout_s: float | None = None):
    """Yield the records of an NDJSON file (or file-like), optionally tailing.

    With ``follow=True`` the generator keeps polling for appended lines, the
    reading half of a live dashboard.  It stops at a ``{"type": "end"}``
    record, after ``timeout_s`` without new data, or (not following) at EOF.
    """
    f = source if hasattr(source, "readline") else open(source)
    owns = f is not source
    waited = 0.0
    try:
        buf = ""
        while True:
            line = f.readline()
            if not line:
                if not follow:
                    return
                if timeout_s is not None and waited >= timeout_s:
                    return
                time.sleep(poll_s)
                waited += poll_s
                continue
            buf += line
            if not buf.endswith("\n"):
                continue  # a writer's partial line: wait for the rest
            waited = 0.0
            rec = json.loads(buf)
            buf = ""
            yield rec
            if rec.get("type") == "end":
                return
    finally:
        if owns:
            f.close()


# --------------------------------------------------------------------------
# TraceRecorder: spans and counters around a run
# --------------------------------------------------------------------------


class _Span:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._name, time.perf_counter() - self._t0)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class TraceRecorder:
    """Host-side flight recorder: named wall-clock spans, counters, notes.

    Spans accumulate (total seconds, call count) a name; counters are
    monotonic (``count``) or last-write-wins gauges (``gauge``).  An optional
    sink receives every span as a record the moment it closes.
    """

    def __init__(self, sink: Sink | None = None):
        self.spans: dict[str, list] = {}  # name -> [total_s, count]
        self.counters: dict[str, float] = {}
        self.notes: dict[str, Any] = {}
        self._sink = sink

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def record(self, name: str, seconds: float) -> None:
        e = self.spans.get(name)
        if e is None:
            self.spans[name] = [seconds, 1]
        else:
            e[0] += seconds
            e[1] += 1
        if self._sink is not None:
            self._sink.emit({"type": "span", "name": name, "s": round(seconds, 6)})

    def count(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.counters[name] = value

    def note(self, name: str, value: Any) -> None:
        self.notes[name] = value

    def total(self, name: str) -> float:
        e = self.spans.get(name)
        return e[0] if e else 0.0

    def summary(self) -> dict:
        return dict(
            spans={n: dict(total_s=round(t, 6), count=c) for n, (t, c) in self.spans.items()},
            counters={n: (v if isinstance(v, (int, bool)) else float(v))
                      for n, v in self.counters.items()},
            notes=dict(self.notes),
        )


class NullRecorder:
    """A no-op recorder with ``TraceRecorder``'s API; ``span`` returns one
    shared no-op context manager."""

    spans: dict = {}
    counters: dict = {}
    notes: dict = {}

    def span(self, name: str):
        return _NULL_SPAN

    def record(self, name: str, seconds: float) -> None:
        pass

    def count(self, name: str, inc: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def note(self, name: str, value: Any) -> None:
        pass

    def total(self, name: str) -> float:
        return 0.0

    def summary(self) -> dict:
        return dict(spans={}, counters={}, notes={})


NULL_RECORDER = NullRecorder()


def maybe(recorder) -> TraceRecorder | NullRecorder:
    """``None`` becomes the shared no-op recorder."""
    return NULL_RECORDER if recorder is None else recorder


# --------------------------------------------------------------------------
# the run manifest: a self-describing sidecar JSON
# --------------------------------------------------------------------------


def _hash_tree(h, tree) -> None:
    """Feed a tree of NamedTuples, dicts, sequences, tensors and arrays to
    ``h``: its structure (type and field names, dict keys in sorted order),
    then each leaf's shape, dtype and bytes."""
    if tree is None:
        h.update(b"<none>")
    elif isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        h.update(f"<{type(tree).__name__}:{','.join(tree._fields)}>".encode())
        for v in tree:
            _hash_tree(h, v)
    elif isinstance(tree, dict):
        keys = sorted(tree)
        h.update(f"<dict:{','.join(map(str, keys))}>".encode())
        for k in keys:
            _hash_tree(h, tree[k])
    elif isinstance(tree, (list, tuple)):
        h.update(f"<seq:{len(tree)}>".encode())
        for v in tree:
            _hash_tree(h, v)
    else:
        a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(np.ascontiguousarray(a).tobytes())


def scenario_hash(*trees) -> str:
    """A deterministic content hash over scenario trees (workload, platform,
    subsystem states): their structure, leaf shapes and dtypes, and leaf
    bytes, so two runs share a hash iff they simulate the same scenario.
    ``None`` hashes to a fixed token (a subsystem off).

    The hash is the port's own: the JAX package hashes the ``repr`` of its
    pytree definitions, so the two packages give different hashes for the
    same scenario."""
    h = hashlib.sha256()
    for tree in trees:
        _hash_tree(h, tree)
    return h.hexdigest()[:16]


def jsonable(tree):
    """A tree as plain JSON-serialisable Python: NamedTuples become dicts by
    field, tensors and arrays (nested) lists or scalars, ``None`` stays."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        return {k: jsonable(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {str(k): jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jsonable(v) for v in tree]
    if isinstance(tree, (str, bool, int, float)):
        return tree
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return a.item() if a.ndim == 0 else a.tolist()


def _torch_block() -> dict:
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    return {
        "version": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": count,
        "device_names": sorted({torch.cuda.get_device_name(i) for i in range(count)}),
    }


def run_manifest(
    *,
    jobs=None,
    sites=None,
    ext=None,
    subsystems: tuple = (),
    recorder=None,
    extra: dict | None = None,
) -> dict:
    """A manifest dict: the environment, the scenario's identity and the
    telemetry; what a hunt for a speed regression asks first."""
    import platform as _platform
    import sys

    m: dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": round(time.time(), 3),
        "torch": _torch_block(),
        "versions": {
            "python": _platform.python_version(),
            "numpy": np.__version__,
            "torch": torch.__version__,
        },
        "platform": _platform.platform(),
        "argv": list(sys.argv),
    }
    if jobs is not None or sites is not None or ext is not None:
        names = [s.name for s in subsystems] if subsystems else sorted(ext or {})
        m["scenario"] = {
            "hash": scenario_hash(jobs, sites, ext),
            "n_jobs": int(jobs.valid.sum()) if jobs is not None else None,
            "job_capacity": jobs.capacity if jobs is not None else None,
            "n_sites": sites.capacity if sites is not None else None,
            "subsystems": names,
        }
    if recorder is not None:
        m["telemetry"] = recorder.summary()
    if extra:
        m["extra"] = extra
    return m


def manifest_path(artifact_path) -> pathlib.Path:
    """``run.ndjson`` -> ``run.ndjson.manifest.json``."""
    p = pathlib.Path(artifact_path)
    if p.name.endswith(MANIFEST_SUFFIX):
        return p
    return p.with_name(p.name + MANIFEST_SUFFIX)


def write_manifest(artifact_path, manifest: dict) -> pathlib.Path:
    """Write ``manifest`` as the sidecar of ``artifact_path`` and return the
    sidecar's path; the artifact itself is not touched."""
    path = manifest_path(artifact_path)
    path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return path


def read_manifest(artifact_path) -> dict:
    return json.loads(manifest_path(artifact_path).read_text())


# environment keys whose drift between two manifests explains a speed drift
_DRIFT_KEYS = (
    ("torch", "version"),
    ("torch", "cuda"),
    ("torch", "backend"),
    ("torch", "device_count"),
    ("torch", "device_names"),
    ("versions", "python"),
    ("versions", "numpy"),
)


def manifest_drift(fresh: dict, baseline: dict) -> list[dict]:
    """The environment's differences between two manifests (empty: the same
    environment).  Scenario hashes and telemetry are not compared."""
    diffs = []
    for section, key in _DRIFT_KEYS:
        a = (fresh.get(section) or {}).get(key)
        b = (baseline.get(section) or {}).get(key)
        if a != b:
            diffs.append({"key": f"{section}.{key}", "fresh": a, "baseline": b})
    return diffs


# --------------------------------------------------------------------------
# lane occupancy of scenario ensembles
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lane_occupancy(result, buckets=None) -> dict:
    """Per-lane occupancy of an ensemble ``SimResult`` (leading K).

    Per lane: rounds executed, ``active_frac`` (its rounds over the slowest
    lane's: the lock-step share the batched loop spends on it), valid jobs
    and padding.  When the run logged frames (``log_rows > 0``), each lane
    also reports ``work_round_frac``, the share of its logged rounds with
    QUEUED or ASSIGNED rows (rounds the phase-skip guard could not skip),
    and ``skip_frac``, its complement.  ``buckets`` (a ``ScenarioBuckets``)
    adds ``ScenarioBuckets.padding_stats``."""
    from .types import ASSIGNED, QUEUED

    rounds = np.atleast_1d(_host(result.rounds)).reshape(-1)
    K = rounds.size
    valid = _host(result.jobs.valid).reshape(K, -1)
    cap = valid.shape[-1]
    n_valid = valid.sum(-1)
    max_r = max(int(rounds.max()), 1)

    work_frac = [None] * K
    log = getattr(result, "log", None)
    if log is not None and _host(log.time).ndim >= 1:
        counts = _host(log.counts)
        counts = counts.reshape(K, -1, counts.shape[-1])
        ridx = _host(log.round_idx).reshape(K, -1)
        for i in range(K):
            m = ridx[i] >= 0
            if m.any():
                work = (counts[i, m, QUEUED] + counts[i, m, ASSIGNED]) > 0
                work_frac[i] = float(work.mean())

    lanes = []
    for i in range(K):
        lane = dict(
            lane=i,
            rounds=int(rounds[i]),
            active_frac=round(float(rounds[i]) / max_r, 4),
            n_jobs=int(n_valid[i]),
            padded_rows=int(cap - n_valid[i]),
            padding_frac=round(1.0 - float(n_valid[i]) / max(cap, 1), 4),
        )
        if work_frac[i] is not None:
            lane["work_round_frac"] = round(work_frac[i], 4)
            lane["skip_frac"] = round(1.0 - work_frac[i], 4)
        lanes.append(lane)

    wf = [w for w in work_frac if w is not None]
    out = dict(
        lanes=lanes,
        summary=dict(
            n_lanes=K,
            rounds_max=int(rounds.max()),
            rounds_total=int(rounds.sum()),
            active_frac_mean=round(float(rounds.mean()) / max_r, 4),
            lockstep_waste_frac=round(1.0 - float(rounds.sum()) / (K * max_r), 4),
            padding_frac_mean=round(1.0 - float(n_valid.mean()) / max(cap, 1), 4),
            **({"work_round_frac_mean": round(float(np.mean(wf)), 4),
                "skip_frac_mean": round(1.0 - float(np.mean(wf)), 4)} if wf else {}),
        ),
    )
    if buckets is not None:
        out["buckets"] = buckets.padding_stats()
    return out
