"""The LM workload layer's link into the simulator in the port:
``workload.lm_job_records`` turns (arch x shape) cells into job records
equal to the JAX package's, and the records run through ``simulate`` to
the JAX package's result, exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.workload import lm_job_records as jax_lm_job_records  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from test_torch_ensemble import _assert_same, _flat  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

# examples/lm_grid_workload.py's fleet, plus a cell on the defaults
CELLS = [
    dict(name="llama3-405b:train_4k", flops=2.5e18, cores=8, memory_gb=32, bytes_in=5e9,
         steps=20),
    dict(name="kimi-k2:train_4k", flops=2.0e17, cores=8, memory_gb=32, bytes_in=5e9, steps=20),
    dict(name="mamba2:decode_32k", flops=5e13, cores=1, memory_gb=8, bytes_in=1e9, steps=100),
    dict(name="whisper-small:prefill_32k", flops=3e14, bytes=2e9),
]


@pytest.mark.parametrize("jobs_per_cell,seed", [(8, 0), (6, 3)])
def test_records_equal_jax(jobs_per_cell, seed):
    want = jax_lm_job_records(CELLS, jobs_per_cell=jobs_per_cell, seed=seed)
    got = T.lm_job_records(CELLS, jobs_per_cell=jobs_per_cell, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_records_simulate_as_jax():
    records = T.lm_job_records(CELLS, jobs_per_cell=6, seed=0)
    sites_j = R.atlas_like_platform(25, seed=1)
    rj = R.simulate(R.from_records(records), sites_j, R.get_policy("shortest_wait"),
                    jax.random.PRNGKey(0), max_rounds=5000)
    rt = T.simulate(T.from_records(records, device="cpu"),
                    T.atlas_like_platform(25, seed=1, device="cpu"),
                    T.get_policy("shortest_wait"), PRNGKey(0), max_rounds=5000, device="cpu")
    _assert_same(_flat(rj), _flat(rt))
    assert int((rt.jobs.state == T.DONE).sum()) == len(records["arrival"])
