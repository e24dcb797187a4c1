"""The subsystem path on the card against the CPU: availability (preemption
and brown-out) and workflow DAGs through capacity dispatch (the assign
kernel) and the fused sparse path (the fused kernel), with the segment sum
in every round.  Marked ``cuda``: they skip where no GPU is present.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_subsystems_cuda.py

Exact: rounds, makespan, every job column, the site counters, the
subsystem states, the log's ``site_avail`` column and the Table-1
transition rows.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign  # noqa: E402
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign import fused_cuda as fused_mod  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod  # noqa: E402

S = 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _run(device, fused: bool):
    scn = T.atlas_mc_workflows(60, seed=0, arrival_span=3600.0, device=device)
    sites = T.atlas_like_platform(S, seed=1, fail_rate=0.02, device=device)
    # preempting outages on the sites that carry the load (6, then 3), a
    # drain window, and brown-outs on a third of the sites
    windows = [dict(site=6, start=1000.0, end=1600.0, preempt=True),
               dict(site=3, start=2000.0, end=2600.0, preempt=True),
               dict(site=10, start=500.0, end=3000.0)]
    windows += [dict(site=s, start=0.0, end=40000.0, factor=0.5) for s in range(1, S, 3)]
    av = T.make_availability(S, windows, device=device)
    base = T.get_policy("critical_path_first")
    policy = (T.with_fused_assign(base, make_fused_capacity_assign(scn.jobs.cores)) if fused
              else T.with_capacity_assign(base, make_capacity_assign(scn.jobs.cores)))
    return T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), availability=av,
                      workflow=scn.workflow, log_rows=32, max_rounds=400,
                      topk=4 if fused else None, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_subsystem_run_card_equals_cpu(cuda_device, fused):
    assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
    card = _run(cuda_device, fused)
    torch.cuda.synchronize()
    launched = fused_mod.launches if fused else assign_mod.launches
    assert launched > 0 and segsum_mod.launches > 0
    cpu = _run(torch.device("cpu"), fused)
    a, b = T.result_to_numpy(card), T.result_to_numpy(cpu)
    assert a["rounds"] == b["rounds"] and a["makespan"] == b["makespan"]
    for group in ("jobs", "sites", "avail", "wf"):
        for k, v in b[group].items():
            np.testing.assert_array_equal(a[group][k], v, err_msg=f"{group}.{k}")
    np.testing.assert_array_equal(a["log"]["extra"]["site_avail"],
                                  b["log"]["extra"]["site_avail"])
    assert int(cpu.avail.n_preempted.sum()) > 0
    assert TE.to_csv(TE.transition_rows(card)) == TE.to_csv(TE.transition_rows(cpu))
    texts = []
    for res in (card, cpu):
        buf = io.StringIO()
        TE.write_ml_dataset(res, buf, segment=100)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
