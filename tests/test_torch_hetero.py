"""The heterogeneous-cluster ILP (paper Appendix A.2) on the port
(``repro_torch.core.hetero``) against the JAX package's, on the CPU:
``hetero_matrix`` bitwise and ``solve_hetero``'s allocation, objective and
fair floor exactly, on the reference's scenarios (``tests/test_hetero.py``),
with the reference's invariants on the port's results.
"""
import pytest

from repro.core import cluster as J_cluster
from repro.core import hetero as J_het
from repro.core import sensitivity as J_sens
from repro.core import trace as J_trace
from repro_torch.core import cluster as P_cluster
from repro_torch.core import hetero as P_het
from repro_torch.core import sensitivity as P_sens
from repro_torch.core import trace as P_trace

SIDES = {"jax": (J_cluster, J_het, J_sens, J_trace),
         "port": (P_cluster, P_het, P_sens, P_trace)}


def _types(side):
    cl, het = SIDES[side][:2]
    return [het.MachineType("v100", n_machines=2,
                            spec=cl.ServerSpec(8, 24.0, 500.0),
                            gpu_speed=1.0),
            het.MachineType("a100", n_machines=1,
                            spec=cl.ServerSpec(8, 48.0, 1000.0),
                            gpu_speed=2.0)]


def _jobs(side, n, seed):
    # the runnable set's GPU demand must fit the 24-GPU cluster
    trace = SIDES[side][3]
    jobs = trace.generate(trace.TraceConfig(
        n_jobs=3 * n, split=(40, 40, 20), arrival="static", seed=seed,
        multi_gpu=False))
    return jobs[:n]


def test_hetero_matrix_matches():
    for name in P_sens.MODEL_ZOO:
        for gpus in (1, 4):
            got = {}
            for side in SIDES:
                het, sens = SIDES[side][1:3]
                for t in _types(side):
                    m = het.hetero_matrix(sens.MODEL_ZOO[name], gpus, t,
                                          [24.0, 1.0, 3.0, 9.0, 12.0],
                                          [20.0, 62.5, 500.0, 50.0])
                    got.setdefault(side, []).append(
                        (m.cpu_points.tolist(), m.mem_points.tolist(),
                         m.W.tobytes(), m.gpus))
            assert got["port"] == got["jax"], (name, gpus)


@pytest.mark.parametrize("n,seed", [(8, 0), (16, 3), (12, 5)])
def test_solve_hetero_matches(n, seed):
    out = {}
    for side in SIDES:
        het = SIDES[side][1]
        jobs = _jobs(side, n, seed)
        res = het.solve_hetero(jobs, _types(side), time_limit=20.0)
        out[side] = (res.alloc, res.throughput, res.fair_throughput,
                     res.unplaced)
    assert out["port"] == out["jax"]
    # the reference's invariants, on the port's result
    jobs, types = _jobs("port", n, seed), _types("port")
    res = P_het.solve_hetero(jobs, types, time_limit=20.0)
    assert set(res.alloc) == {j.job_id for j in jobs}
    assert res.throughput >= res.fair_throughput - 1e-6
    used = {t.name: [0.0, 0.0, 0] for t in types}
    for j in jobs:
        t, c, m = res.alloc[j.job_id]
        assert c >= 1 and m >= 0
        used[t][0] += c
        used[t][1] += m
        used[t][2] += j.gpu_demand
    for t in types:
        assert used[t.name][0] <= t.spec.cpus * t.n_machines + 1e-6
        assert used[t.name][1] <= t.spec.mem * t.n_machines + 1e-6
        assert used[t.name][2] <= t.spec.gpus * t.n_machines
    if n == 16:                  # the fast type is exploited
        assert res.throughput > res.fair_throughput


def test_solve_hetero_fair_oracle_matches():
    out = {}
    for side in SIDES:
        jobs = _jobs(side, 10, 2)
        oracle = {j.job_id: 50.0 + j.job_id for j in jobs}
        res = SIDES[side][1].solve_hetero(jobs, _types(side), mem_unit=100.0,
                                          time_limit=20.0, fair_oracle=oracle)
        out[side] = (res.alloc, res.throughput, res.fair_throughput,
                     res.unplaced)
    assert out["port"] == out["jax"]
