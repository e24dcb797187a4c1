"""Result consumers: the port's event rows, ML dataset exports and monitor
renderings against the JAX package's, from the same run on the CPU.

Byte-identical: every ``to_csv``/``to_json`` of a ``*_rows`` export, the
``ml_dataset`` arrays, ``write_ml_dataset``'s NDJSON at two segment sizes,
the log frames, the rendered dashboards and the timelines.
"""
import io

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.events as RE  # noqa: E402
import repro.core.monitor as RM  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.events as TE  # noqa: E402
import repro_torch.core.monitor as TM  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

SITE_NAMES = ["CERN-PROD", "BNL-ATLAS", "TRIUMF", "RAL"]


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def runs():
    """``{"plain": (jax, port), "avail+wf": (jax, port)}`` on the golden
    matrix scenario, with a 64-row event log written every round."""
    scn = matrix_scenario()
    out = {}
    for name, avail, wf in (("plain", False, False), ("avail+wf", True, True)):
        jobs, kw = combo_kwargs(scn, False, avail, wf)
        rj = R.simulate(jobs, scn["sites"], R.get_policy("panda_dispatch"),
                        jax.random.PRNGKey(0), log_rows=64, **kw)
        tkw = {}
        if avail:
            tkw["availability"] = T.availability_from_numpy(_np_state(kw["availability"]),
                                                            device="cpu")
        if wf:
            tkw["workflow"] = T.workflow_from_numpy(_np_state(kw["workflow"]), device="cpu")
        rt = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                        T.sites_from_numpy(_np_state(scn["sites"]), device="cpu"),
                        T.get_policy("panda_dispatch"), PRNGKey(0), log_rows=64, device="cpu",
                        **tkw)
        out[name] = (rj, rt)
    return out


ROWS = ["transition_rows", "transfer_rows", "job_rows", "workflow_rows", "availability_rows",
        "fault_rows"]


@pytest.mark.parametrize("run", ["plain", "avail+wf"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("names", [None, SITE_NAMES])
def test_rows_are_byte_identical(runs, run, rows, names):
    rj, rt = runs[run]
    fj, ft = getattr(RE, rows), getattr(TE, rows)
    a = fj(rj) if rows == "workflow_rows" else fj(rj, names)
    b = ft(rt) if rows == "workflow_rows" else ft(rt, names)
    assert TE.to_csv(b) == RE.to_csv(a)
    assert TE.to_json(b) == RE.to_json(a)
    if run == "avail+wf" and rows in ("transition_rows", "job_rows", "workflow_rows",
                                      "availability_rows"):
        assert b, f"{rows} gave no rows"


@pytest.mark.parametrize("run", ["plain", "avail+wf"])
def test_ml_dataset_and_ndjson(runs, run, tmp_path):
    rj, rt = runs[run]
    a, b = RE.ml_dataset(rj), TE.ml_dataset(rt)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if run == "avail+wf":
        assert "n_preempted" in list(b["feature_names"])
    texts = {}
    for segment in (0, 7):
        fj, ft = io.StringIO(), io.StringIO()
        nj, nt = RE.write_ml_dataset(rj, fj, segment=segment), TE.write_ml_dataset(rt, ft,
                                                                                  segment=segment)
        assert nj == nt == len(b["walltime"])
        assert ft.getvalue() == fj.getvalue()
        texts[segment] = ft.getvalue()
    assert texts[0] == texts[7]
    path = tmp_path / "ml.ndjson"
    TE.write_ml_dataset(rt, str(path), segment=5)
    back = TE.read_ml_trace(str(path))
    want = RE.read_ml_trace(io.StringIO(texts[0]))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    for k, v in RE.recorded_trace(rj).items():
        np.testing.assert_array_equal(TE.recorded_trace(rt)[k], v, err_msg=k)
    with pytest.raises(ValueError, match="ml_header"):
        TE.read_ml_trace(io.StringIO('{"type": "x"}\n'))


class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("run", ["plain", "avail+wf"])
def test_frames_and_streams(runs, run):
    rj, rt = runs[run]
    fj, ft = RE.log_frames(rj), TE.log_frames(rt)
    assert ft == fj and ft == list(TE.iter_frames(rt))
    if run == "avail+wf":
        assert "site_avail" in ft[0]
    kinds = tuple(TE._STREAMS)
    sj, st = _Sink(), _Sink()
    assert (RE.stream_rows(rj, sj, kinds=kinds, site_names=SITE_NAMES)
            == TE.stream_rows(rt, st, kinds=kinds, site_names=SITE_NAMES))
    assert st.records == sj.records
    with pytest.raises(ValueError, match="unknown stream kind"):
        TE.stream_rows(rt, st, kinds=("nope",))


TIMELINES = ["utilization_timeline", "storage_timeline", "network_timeline",
             "link_occupancy_timeline", "transfer_queue_timeline", "availability_timeline",
             "fault_score_timeline", "blacklist_timeline"]


@pytest.mark.parametrize("run", ["plain", "avail+wf"])
def test_monitor_renderings(runs, run):
    rj, rt = runs[run]
    for names in (None, SITE_NAMES):
        oj, ot = io.StringIO(), io.StringIO()
        RM.render_run(rj, names, every=3, out=oj)
        TM.render_run(rt, names, every=3, out=ot)
        assert ot.getvalue() == oj.getvalue()
    assert TM.frames_json(rt) == RM.frames_json(rj)
    for name in TIMELINES:
        a, b = getattr(RM, name)(rj), getattr(TM, name)(rt)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(TM.extra_timeline(rt, "site_avail", 2.0),
                                  RM.extra_timeline(rj, "site_avail", 2.0))
    wj, wt = RM.workflow_timeline(rj), TM.workflow_timeline(rt)
    for a, b in zip(wj, wt):
        np.testing.assert_array_equal(a, b)
    assert TM.render_workflows(rt) == RM.render_workflows(rj)
    util = TM.utilization_timeline(rt).mean(-1)
    assert TM.sparkline(util) == RM.sparkline(RM.utilization_timeline(rj).mean(-1))
    assert TM.sparkline(np.zeros(0)) == ""
    frame = TE.log_frames(rt)[-1]
    cores = rt.sites.cores
    for disk_cap in (None, np.full(4, 1e13)):
        assert (TM.render_frame(frame, cores, SITE_NAMES, max_sites=3, disk_cap=disk_cap)
                == RM.render_frame(frame, np.asarray(rj.sites.cores), SITE_NAMES, max_sites=3,
                                   disk_cap=disk_cap))
    for used, total in ((0, 0), (5, 10), (30, 10)):
        assert TM.pressure_bar(used, total, 8) == RM.pressure_bar(used, total, 8)
