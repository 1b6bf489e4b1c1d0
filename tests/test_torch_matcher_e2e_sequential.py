"""tests/test_matcher_e2e.py's sequential IcpPM (type 1) and NDT (type 5)
runs through the port on the CPU, under that file's ATE bounds."""
from torch_matcher_e2e import ATE_BOUND, NDT_SCANS, run_ate


def test_icp_pm_e2e():
    """Type 1, IcpUsingPointMatcher (icp_pointmatcher.cc)."""
    ate = run_ate(1)
    assert ate < ATE_BOUND[1], f"IcpPM e2e ATE {ate}"


def test_ndt_e2e():
    """Type 5, the OpenMP-NDT equivalent (ndt.cc:38-64)."""
    ate = run_ate(5, **NDT_SCANS)
    assert ate < ATE_BOUND[5], f"Ndt e2e ATE {ate}"
