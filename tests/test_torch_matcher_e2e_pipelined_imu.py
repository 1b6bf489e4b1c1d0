"""tests/test_matcher_e2e.py::test_pipelined_imu_e2e through the port on the
CPU: the chunked type-6 front end on a turning trajectory, with the gyro
rows riding with each chunk, must track at least as well as CTRV, under
that test's assertion."""
from torch_matcher_e2e import run_ate


def test_pipelined_imu_e2e():
    run = dict(n_scans=24, step=1.0, max_points=8000, pipelined=True,
               trajectory="square", seed=9)
    ate_ctrv = run_ate(6, **run)
    ate_imu = run_ate(6, use_imu=True, **run)
    assert ate_imu < max(1.05 * ate_ctrv, 0.3), (ate_imu, ate_ctrv)
