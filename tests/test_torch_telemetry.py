"""Segmented runs and the flight recorder in the port (``engine.init_sim``/
``advance_sim``/``finish_sim``, ``monitor.watch``, ``core/telemetry.py``,
the ``repro_torch.monitor`` command line) against the JAX package's, on the
CPU.

Exact throughout: a segmented run equals one ``simulate`` call bit for bit,
both equal the JAX package's run, and the frame streams and the rendered
dashboard are the same bytes.
"""
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.engine as RENG  # noqa: E402
import repro.core.monitor as RM  # noqa: E402
import repro.core.telemetry as RTEL  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.engine as TENG  # noqa: E402
import repro_torch.core.monitor as TM  # noqa: E402
import repro_torch.core.telemetry as TTEL  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_data import _check_group, _np_state  # noqa: E402
from test_torch_faults import _run, _to_port, assert_same_faults  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SITE_NAMES = ["CERN-PROD", "BNL-ATLAS", "TRIUMF", "RAL"]


@pytest.fixture(scope="module")
def scenario():
    """The golden matrix's ``avail+faults`` row in both packages' forms."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, False, True, False)
    kw["faults"] = R.make_faults(4, jobs.capacity, job_backoff=60.0, walltime=4000.0,
                                 blacklist_threshold=0.5, blacklist_alpha=0.5,
                                 blacklist_cooldown=1800.0)
    port = dict(availability=T.availability_from_numpy(_np_state(kw["availability"]),
                                                       device="cpu"),
                faults=_to_port(kw["faults"]))
    return dict(jobs=jobs, sites=scn["sites"], kw=kw,
                jobs_t=T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                sites_t=T.sites_from_numpy(_np_state(scn["sites"]), device="cpu"), port=port)


def _port_run(sc, **kw):
    return T.simulate(sc["jobs_t"], sc["sites_t"], T.get_policy("panda_dispatch"), PRNGKey(0),
                      device="cpu", **sc["port"], **kw)


def _same(a, b):
    _check_group(T.result_to_numpy(a), T.result_to_numpy(b), "run")


def test_segments_equal_one_call(scenario):
    """``init_sim`` then ``advance_sim`` over uneven horizons, then
    ``finish_sim``, equals one ``simulate`` call, which equals the JAX
    package's; ``sim_active`` reads the paused handle."""
    whole = _port_run(scenario, log_rows=512)
    h = T.init_sim(scenario["jobs_t"], scenario["sites_t"], T.get_policy("panda_dispatch"),
                   PRNGKey(0), device="cpu", log_rows=512, **scenario["port"])
    assert T.sim_active(h) and h.max_rounds == 100_000 and h.state.round == 0
    rounds = []
    for edge in (0.0, 137.5, 900.0, 900.0, 5000.25, 12345.0):
        h = T.advance_sim(h, edge)
        assert float(h.state.clock) > edge        # the loop pauses past the horizon
        rounds.append(h.state.round)
    assert rounds[0] >= 1 and rounds[2] == rounds[3] and rounds[-1] > rounds[2]
    assert T.sim_active(h)
    h = T.advance_sim(h)
    assert not T.sim_active(h)
    _same(whole, T.finish_sim(h))
    rj = R.simulate(scenario["jobs"], scenario["sites"], R.get_policy("panda_dispatch"),
                    jax.random.PRNGKey(0), log_rows=512, **scenario["kw"])
    assert_same_faults(rj, whole)
    # a round budget stops the handle too
    h = T.init_sim(scenario["jobs_t"], scenario["sites_t"], T.get_policy("panda_dispatch"),
                   PRNGKey(0), device="cpu", max_rounds=7, **scenario["port"])
    assert not T.sim_active(T.advance_sim(h)) and T.advance_sim(h).state.round == 7


def test_horizon_compares_in_float32():
    """The loop compares the clock with ``float32(horizon)``, as the JAX
    package does: 16777217.5 rounds up to 16777218.0, so the round that
    reaches 16777218 is followed by one more, which a float64 comparison
    would stop."""
    h = 16777217.5
    assert TENG._f32(h) == 16777218.0 > h
    jobs = R.synthetic_panda_jobs(6, seed=1)
    arrival = np.float32([100.0, 16777216.0, 16777218.0, 16777220.0, 16777300.0, 16777400.0])
    jobs = jobs._replace(arrival=jnp.asarray(arrival))
    sites = R.atlas_like_platform(3, seed=0)
    rj = R.simulate(jobs, sites, R.get_policy("panda_dispatch"), jax.random.PRNGKey(0),
                    horizon=h)
    jt = T.jobs_from_numpy(_np_state(jobs), device="cpu")
    st = T.sites_from_numpy(_np_state(sites), device="cpu")
    pol = T.get_policy("panda_dispatch")
    rt = T.simulate(jt, st, pol, PRNGKey(0), horizon=h, device="cpu")
    seg = T.finish_sim(T.advance_sim(T.init_sim(jt, st, pol, PRNGKey(0), device="cpu"), h))
    hj = RENG.advance_sim(RENG.init_sim(jobs, sites, R.get_policy("panda_dispatch"),
                                        jax.random.PRNGKey(0)), h)
    assert int(rj.rounds) == rt.rounds == seg.rounds == int(hj.state.round)
    assert float(rt.makespan) == float(rj.makespan) == 16777220.0
    _same(rt, seg)
    # stopping at 16777218 exactly (representable) runs the same rounds;
    # below it, one round fewer
    below = T.simulate(jt, st, pol, PRNGKey(0), horizon=16777216.0, device="cpu")
    assert below.rounds == rt.rounds - 1


def test_watch_equals_simulate_and_streams(scenario, tmp_path):
    """``watch`` in segments with an NDJSON sink and a recorder equals one
    ``simulate`` call; its frame stream and rendered frames are the JAX
    package's bytes."""
    whole = _port_run(scenario, log_rows=128)
    path = tmp_path / "run.ndjson"
    rec = T.TraceRecorder()
    out_t = io.StringIO()
    with T.NDJSONSink(path) as sink:
        res = TM.watch(scenario["jobs_t"], scenario["sites_t"], T.get_policy("panda_dispatch"),
                       PRNGKey(0), frames=8, horizon=30000.0, sink=sink, site_names=SITE_NAMES,
                       out=out_t, recorder=rec, log_rows=128, device="cpu", **scenario["port"])
    _same(whole, res)
    s = rec.summary()
    n_seg = s["counters"]["watch_segments"]
    assert n_seg > 3 and s["spans"]["watch_segment"]["count"] == n_seg
    assert s["counters"]["rounds_executed"] == res.rounds
    ref_sink = RTEL.MemorySink()
    out_j = io.StringIO()
    RM.watch(scenario["jobs"], scenario["sites"], R.get_policy("panda_dispatch"),
             jax.random.PRNGKey(0), frames=8, horizon=30000.0, sink=ref_sink,
             site_names=SITE_NAMES, out=out_j, log_rows=128, **scenario["kw"])
    recs = list(T.iter_ndjson(path))
    assert recs == json.loads(json.dumps(ref_sink.records))
    assert [r["type"] for r in recs] == ["run_meta"] + ["frame"] * n_seg + ["end"]
    assert out_t.getvalue() == out_j.getvalue() and "CERN-PROD" in out_t.getvalue()
    # the open-horizon form drains to the end, frames by the arrival span
    mem = T.MemorySink()
    res2 = TM.watch(scenario["jobs_t"], scenario["sites_t"], T.get_policy("panda_dispatch"),
                    PRNGKey(0), frames=5, sink=mem, render=False, log_rows=128, device="cpu",
                    **scenario["port"])
    _same(whole, res2)
    assert mem.records[-1]["type"] == "end" and mem.records[-1]["rounds"] == res2.rounds
    # follow_stream renders the stream as the JAX package's does
    a, b = io.StringIO(), io.StringIO()
    shown = TM.follow_stream(path, every=3, out=a)
    assert shown == RM.follow_stream(path, every=3, out=b) == len(range(0, n_seg, 3))
    assert a.getvalue() == b.getvalue() and a.getvalue().endswith(
        f"end: rounds={res.rounds} makespan={float(res.makespan)}\n")


def test_state_frame(scenario):
    hj = RENG.advance_sim(RENG.init_sim(scenario["jobs"], scenario["sites"],
                                        R.get_policy("panda_dispatch"), jax.random.PRNGKey(0),
                                        **scenario["kw"]), 2500.0)
    ht = T.advance_sim(T.init_sim(scenario["jobs_t"], scenario["sites_t"],
                                  T.get_policy("panda_dispatch"), PRNGKey(0), device="cpu",
                                  **scenario["port"]), 2500.0)
    assert TM.state_frame(ht) == RM.state_frame(hj)
    assert TM.state_frame(ht)["counts"]["running"] > 0


def test_recorder_in_simulate(scenario):
    """``simulate(recorder=)`` gives the same result; its spans and gauges."""
    sink = T.MemorySink()
    rec = T.TraceRecorder(sink=sink)
    res = _port_run(scenario, recorder=rec, max_rounds=50)
    _same(_port_run(scenario, max_rounds=50), res)
    s = rec.summary()
    assert sorted(s["spans"]) == ["dispatch", "execute"]
    assert s["counters"] == dict(rounds_executed=50, round_budget=50, early_exit_rounds=0,
                                 n_jobs=60, n_sites=4)
    rec = T.TraceRecorder()
    res = _port_run(scenario, recorder=rec, max_rounds=1000)      # drains early
    assert rec.counters["early_exit_rounds"] == 1000 - res.rounds > 0
    assert s["notes"] == dict(jit_cache_hit=True, subsystems=["availability", "faults"])
    assert [r["name"] for r in sink.records] == ["dispatch", "execute"]
    assert rec.total("dispatch") > 0 and rec.total("nothing") == 0.0


def test_sinks_and_recorders(tmp_path):
    got = []
    cb = T.CallbackSink(got.append)
    cb.emit({"a": 1})
    cb.close()
    assert got == [{"a": 1}]
    T.NullSink().emit({"x": 1})
    assert isinstance(T.MemorySink(), T.Sink) and isinstance(T.NDJSONSink(io.StringIO()), T.Sink)
    buf = io.StringIO()
    sink = T.NDJSONSink(buf, flush_every=2)
    for i in range(3):
        sink.emit({"type": "frame", "i": i, "x": [1.5, None]})
    sink.emit({"type": "end"})
    sink.emit({"type": "after-end"})
    sink.close()
    lines = buf.getvalue().splitlines()
    assert lines[0] == '{"type":"frame","i":0,"x":[1.5,null]}'
    buf.seek(0)
    assert [r.get("i") for r in T.iter_ndjson(buf)] == [0, 1, 2, None]
    # a partial last line waits for its end; following gives up after the timeout
    path = tmp_path / "partial.ndjson"
    path.write_text('{"i": 0}\n{"i": 1')
    assert list(T.iter_ndjson(path, follow=True, poll_s=0.01, timeout_s=0.05)) == [{"i": 0}]
    assert list(T.iter_ndjson(path)) == [{"i": 0}]
    rec = T.TraceRecorder()
    with rec.span("a"):
        pass
    rec.record("a", 0.5)
    rec.count("n")
    rec.count("n", 2)
    rec.gauge("g", 1.25)
    rec.note("k", "v")
    s = rec.summary()
    assert s["spans"]["a"]["count"] == 2 and s["counters"] == {"n": 3, "g": 1.25}
    null = TTEL.maybe(None)
    assert isinstance(null, T.NullRecorder) and TTEL.maybe(rec) is rec
    with null.span("x"):
        null.record("x", 1.0)
        null.count("x")
        null.gauge("x", 1)
        null.note("x", 1)
    assert null.summary() == dict(spans={}, counters={}, notes={}) and null.total("x") == 0.0


def test_manifest_and_drift(scenario, tmp_path):
    rec = T.TraceRecorder()
    _port_run(scenario, recorder=rec, max_rounds=20)
    ext = dict(scenario["port"])
    m = T.run_manifest(jobs=scenario["jobs_t"], sites=scenario["sites_t"], ext=ext,
                       recorder=rec, extra={"cell": "tiny"})
    assert m["schema"] == RTEL.MANIFEST_SCHEMA
    assert m["torch"]["version"] == torch.__version__
    assert m["torch"]["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert m["torch"]["device_count"] == (torch.cuda.device_count()
                                          if torch.cuda.is_available() else 0)
    assert m["versions"]["torch"] == torch.__version__ and "jax" not in m
    assert m["scenario"]["subsystems"] == ["availability", "faults"]
    assert m["scenario"]["n_jobs"] == 60 and m["scenario"]["n_sites"] == 4
    assert m["telemetry"]["counters"]["rounds_executed"] == 20 and m["extra"] == {"cell": "tiny"}
    art = tmp_path / "run.ndjson"
    side = T.write_manifest(art, m)
    assert side.name == "run.ndjson.manifest.json" and not art.exists()
    assert T.read_manifest(art) == T.read_manifest(side) == json.loads(json.dumps(m))
    assert T.manifest_drift(m, json.loads(json.dumps(m))) == []
    old = json.loads(json.dumps(m))
    old["torch"]["version"] = "0.0"
    old["torch"]["device_names"] = ["another card"]
    old["versions"]["numpy"] = "1.0"
    old["scenario"]["hash"] = "0" * 16          # scenarios and telemetry are not compared
    drift = T.manifest_drift(m, old)
    assert [d["key"] for d in drift] == ["torch.version", "torch.device_names",
                                         "versions.numpy"]
    assert drift[0] == {"key": "torch.version", "fresh": torch.__version__, "baseline": "0.0"}
    # the scenario hash: deterministic, content-sensitive, None is a token
    h = T.scenario_hash(scenario["jobs_t"], scenario["sites_t"], ext)
    assert h == m["scenario"]["hash"] and len(h) == 16
    assert h == T.scenario_hash(T.jobs_from_numpy(_np_state(scenario["jobs"]), device="cpu"),
                                scenario["sites_t"], dict(reversed(list(ext.items()))))
    moved = scenario["jobs_t"]._replace(arrival=scenario["jobs_t"].arrival + 1.0)
    assert T.scenario_hash(moved, scenario["sites_t"], ext) != h
    assert T.scenario_hash(None) != T.scenario_hash(scenario["sites_t"]) != T.scenario_hash()
    # jsonable: NamedTuples of tensors become dicts of lists
    j = T.jsonable(dict(f=scenario["port"]["faults"], t=(torch.tensor(2), 1.5, "s", None)))
    assert j["f"]["bl_threshold"] == 0.5 and j["f"]["score"] == [0.0] * 4
    assert j["t"] == [2, 1.5, "s", None]
    assert T.jsonable(None) is None


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)


def test_monitor_cli(scenario, tmp_path):
    """``python -m repro_torch.monitor`` renders a written stream as
    ``python -m repro.monitor`` does; a missing stream exits 2."""
    path = tmp_path / "run.ndjson"
    with T.NDJSONSink(path) as sink:
        TM.watch(scenario["jobs_t"], scenario["sites_t"], T.get_policy("panda_dispatch"),
                 PRNGKey(0), frames=4, horizon=20000.0, sink=sink, render=False, device="cpu",
                 **scenario["port"])
    port = _cli("repro_torch.monitor", "--no-clear", "--every", "2", str(path))
    ref = _cli("repro.monitor", "--no-clear", "--every", "2", str(path))
    assert port.returncode == ref.returncode == 0, port.stderr
    assert port.stdout == ref.stdout and port.stdout.count("round=") == 2
    follow = _cli("repro_torch.monitor", "--follow", "--timeout", "1", str(path))
    assert follow.returncode == 0 and "\x1b[2J" in follow.stdout and "end: rounds=" in follow.stdout
    missing = _cli("repro_torch.monitor", str(tmp_path / "none.ndjson"))
    assert missing.returncode == 2 and "no such stream" in missing.stderr
    empty = tmp_path / "empty.ndjson"
    empty.write_text("")
    out = _cli("repro_torch.monitor", str(empty))
    assert out.returncode == 0 and "(no frames in stream)" in out.stderr
