"""FTS-style transfer queues in the port (``core/transfers.py``) against the
JAX package's, on the same seeded inputs, on the CPU: the ring mechanics
(``_enqueue``, ``_admit``), whole runs of the golden matrix's ``data+tr*``
rows, the ring-full overflow valve, staging jobs that an outage preempts,
and the transfer exports byte for byte.

Tolerances as in ``test_torch_data.py``: exact for ints, states, rounds and
timestamps, ``rtol=1e-6`` for the f32 byte accumulators (which come out
exact here too).  Every run checks the ledger ``n_enq = n_done + n_cancel +
(transfers still queued or active)``.
"""
import io

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.events as RE  # noqa: E402
import repro.core.monitor as RM  # noqa: E402
import repro.core.transfers as RT  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.events as TE  # noqa: E402
import repro_torch.core.monitor as TM  # noqa: E402
import repro_torch.core.transfers as TT  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_data import _np_state, _pols, _port_kw, _run_pair, assert_same_run  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

SITE_NAMES = ["CERN-PROD", "BNL-ATLAS", "TRIUMF", "RAL"]


def _ledger(ts) -> dict:
    in_flight = int((ts.stat > TT.T_IDLE).sum())
    assert int(ts.n_enq) == int(ts.n_done) + int(ts.n_cancel) + in_flight
    return dict(n_enq=int(ts.n_enq), n_done=int(ts.n_done), n_cancel=int(ts.n_cancel),
                in_flight=in_flight, n_overflow=int(ts.n_overflow))


def _same(a, b, what):
    for f, x in _np_state(a).items():
        np.testing.assert_array_equal(np.asarray(x), getattr(b, f).numpy(), err_msg=f"{what}.{f}")


def test_make_transfers_and_init_checks():
    jobs = T.synthetic_panda_jobs(10, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=0, device="cpu")
    for args, kw in (((4, 10), {}), ((3, 7), dict(max_active=2, caps={(0, 1): 5},
                                                   queue_slots=3)),
                     ((2, 5), dict(caps=[[1, 2], [0, 4]], queue_slots=0))):
        _same(R.make_transfers(*args, **kw), T.make_transfers(*args, device="cpu", **kw),
              f"make_transfers{args}")
    ts = T.make_transfers(sites, jobs, device="cpu")     # sizes from the states
    assert ts.queue.shape == (9, 10)
    net = T.uniform_network(3, device="cpu")
    rep = T.make_replicas(np.full(2, 1e9), np.full(3, 1e12), device="cpu")
    kw = dict(data_policy=T.get_data_policy("cache_on_read"), network=net, replicas=rep,
              device="cpu")
    pol, key = T.get_policy("panda_dispatch"), T.PRNGKey(0)
    with pytest.raises(ValueError, match="sized for 12 jobs"):
        T.simulate(jobs, sites, pol, key, transfers=T.make_transfers(3, 12, device="cpu"), **kw)
    with pytest.raises(ValueError, match="expected S\\*S = 9"):
        T.simulate(jobs, sites, pol, key, transfers=T.make_transfers(4, 10, device="cpu"), **kw)


def _random_rings(seed, L=9, Q=6, J=40):
    """A mid-run ring state: entries with live, stale-ticket and cancelled
    rows, partly full rings with wrapped heads, some links at their cap."""
    rng = np.random.default_rng(seed)
    ts = R.make_transfers(3, J, max_active=2, queue_slots=Q)
    qlen = rng.integers(0, Q + 1, L).astype(np.int32)
    qlen[:3] = [Q, Q - 1, 0]                # a full ring, one slot left, an empty one
    head = rng.integers(0, Q, L).astype(np.int32)
    queue = rng.integers(-1, J, (L, Q)).astype(np.int32)
    tickets = rng.integers(0, 30, (L, Q)).astype(np.int32)
    stat = rng.integers(0, 3, J).astype(np.int32)
    ticket = np.where(rng.random(J) < 0.7, tickets.reshape(-1)[rng.integers(0, L * Q, J)],
                      rng.integers(0, 30, J)).astype(np.int32)
    active = rng.integers(0, 3, L).astype(np.int32)
    return ts._replace(queue=jnp.asarray(queue), tickets=jnp.asarray(tickets),
                       qlen=jnp.asarray(qlen), head=jnp.asarray(head), stat=jnp.asarray(stat),
                       ticket=jnp.asarray(ticket), active=jnp.asarray(active),
                       n_enq=jnp.int32(30))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enqueue_and_admit(seed):
    """The ring mechanics on random mid-run rings: same-round enqueuers on
    one link ordered by row, ring-full rows through the overflow valve,
    tombstones popping for free."""
    tj = _random_rings(seed)
    tt = T.transfers_from_numpy(_np_state(tj), device="cpu")
    rng = np.random.default_rng(seed + 10)
    J = tj.stat.shape[0]
    want = (rng.random(J) < 0.4) & (np.asarray(tj.stat) == 0)
    link = rng.integers(-1, 10, J).astype(np.int32)
    link[:6] = [0, 0, 1, 1, 2, 2]           # past a full ring, past one slot
    want[:6] = True
    nbytes = rng.lognormal(np.log(2e9), 1.0, J).astype(np.float32)
    resid = rng.uniform(0, 1e4, J).astype(np.float32)
    cache = rng.random(J) < 0.5
    clock = np.float32(123.25)
    oj, dj = RT._enqueue(tj, *map(jnp.asarray, (want, link, nbytes, resid, cache)), clock)
    ot, dt = TT._enqueue(tt, *map(torch.from_numpy, (want, link, nbytes, resid, cache)),
                         torch.tensor(clock))
    _same(oj, ot, "enqueue")
    np.testing.assert_array_equal(np.asarray(dj)[want], dt.numpy()[want])
    assert int(ot.n_overflow) > 0
    _same(RT._admit(oj, clock), TT._admit(ot, torch.tensor(clock)), "admit")


@pytest.mark.parametrize("combo", ["data+tr", "data+tr+avail", "data+tr+wf", "data+tr+avail+wf"])
def test_matrix_rows(combo):
    """The golden matrix's transfer rows: ``make_transfers(4, J,
    max_active=2)`` on the data rows' scenario."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, "avail" in combo, "wf" in combo)
    kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=2)
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 0, kw, log_rows=32, monitor_every=2)
    assert_same_run(rj, rt)
    led = _ledger(rt.ext["transfers"])
    assert led["n_done"] > 0 and led["n_overflow"] == 0
    assert int(rt.replicas.n_transfers) == led["n_done"]
    # queue waits happened: some transfer waited behind the cap of 2
    assert float(rt.jobs.xfer_wait.max()) > 0.0


def test_ring_overflow():
    """``queue_slots=1`` with one active transfer a link: enqueues past a
    full ring activate at once and ``n_overflow`` counts them."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, False, True)
    kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=1, queue_slots=1)
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 3, kw, log_rows=16)
    assert_same_run(rj, rt)
    assert _ledger(rt.ext["transfers"])["n_overflow"] > 0


def test_preempted_staging_jobs_cancel_and_retry():
    """Short preempting outages over slow links: jobs staging on the WAN
    are preempted, their transfers cancel (tombstones in the rings), and the
    jobs are resubmitted and finish."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, False, False)
    kw["network"] = R.uniform_network(4, bw=5e6, latency=0.05)
    kw["availability"] = R.make_availability(4, [
        dict(site=s, start=300.0 + k * 1500.0, end=450.0 + k * 1500.0, preempt=True)
        for s in (1, 2, 3) for k in range(3)])
    kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=1)
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 0, kw, log_rows=32)
    assert_same_run(rj, rt)
    led = _ledger(rt.ext["transfers"])
    assert led["n_cancel"] > 0 and led["n_done"] > 0
    retried = (rt.jobs.preempted > 0) & (rt.jobs.state == T.DONE)
    assert int(retried.sum()) > 0
    assert float(rt.ext["transfers"].bytes_cancel) > 0.0


def test_sparse_with_transfers():
    """``data_locality`` at ``topk=2`` with the transfer queues: the data
    branch of the candidate index feeding deferred WAN reads."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, True, False)
    kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=2)
    rj, rt = _run_pair(jobs, scn["sites"], *_pols("data_locality"), 0, kw, topk=2,
                       log_rows=16)
    assert_same_run(rj, rt)
    _ledger(rt.ext["transfers"])


def test_pad_jobs_hook():
    for q in (None, 3):
        tj = R.make_transfers(2, 5, queue_slots=q)
        tt = T.transfers_from_numpy(_np_state(tj), device="cpu")
        sj, sub = RT.transfers_subsystem(), TT.transfers_subsystem()
        _same(sj.pad_jobs(sj, tj, 5, 8), sub.pad_jobs(sub, tt, 5, 8), f"pad_jobs(q={q})")
        subs, ext = T.resolve_subsystems(
            data_policy=T.get_data_policy("always_remote"), network=T.uniform_network(2,
                                                                                  device="cpu"),
            replicas=T.make_replicas(np.ones(1), np.ones(2), device="cpu"), transfers=tt,
            validate=False)
        assert [s.name for s in subs] == ["data", "transfers"]
        assert T.pad_ext_jobs(subs, ext, 5, 8)["transfers"].stat.shape == (8,)


@pytest.fixture(scope="module")
def exported():
    """A ``data+tr+avail+wf`` run and a ``data`` run of the matrix scenario
    in both packages, every round logged (the ring holds the whole run)."""
    scn = matrix_scenario()
    out = {}
    for name, tr in (("data", False), ("data+tr+avail+wf", True)):
        jobs, kw = combo_kwargs(scn, True, tr, tr)
        if tr:
            kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=2)
        out[name] = _run_pair(jobs, scn["sites"], *_pols(), 0, kw, port_kw=_port_kw(kw),
                              log_rows=256)
    return out


@pytest.mark.parametrize("run", ["data", "data+tr+avail+wf"])
def test_transfer_exports(exported, run):
    """``transfer_rows`` (the ``xfer_*`` columns now filled),
    ``ml_dataset`` with the transfer-queue columns, ``write_ml_dataset`` at
    two segment sizes, the storage, network and per-link timelines, and the
    rendered dashboard: byte for byte."""
    rj, rt = exported[run]
    for names in (None, SITE_NAMES):
        a, b = RE.transfer_rows(rj, names), TE.transfer_rows(rt, names)
        assert b and TE.to_csv(b) == RE.to_csv(a) and TE.to_json(b) == RE.to_json(a)
    a, b = RE.ml_dataset(rj), TE.ml_dataset(rt)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ("xfer_queue_wait" in list(b["feature_names"])) == ("tr" in run)
    for segment in (0, 7):
        fj, ft = io.StringIO(), io.StringIO()
        RE.write_ml_dataset(rj, fj, segment=segment)
        TE.write_ml_dataset(rt, ft, segment=segment)
        assert ft.getvalue() == fj.getvalue()
    for name in ("storage_timeline", "network_timeline", "link_occupancy_timeline",
                 "transfer_queue_timeline"):
        x, y = getattr(RM, name)(rj), getattr(TM, name)(rt)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    if "tr" in run:
        assert TM.link_occupancy_timeline(rt).max() > 0
        assert TM.transfer_queue_timeline(rt).max() > 0
    oj, ot = io.StringIO(), io.StringIO()
    RM.render_run(rj, SITE_NAMES, every=5, out=oj)
    TM.render_run(rt, SITE_NAMES, every=5, out=ot)
    assert ot.getvalue() == oj.getvalue()
