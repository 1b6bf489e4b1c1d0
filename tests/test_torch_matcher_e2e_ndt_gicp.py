"""tests/test_matcher_e2e.py's sequential NdtWithGicp (type 3) run through
the port on the CPU, under that file's ATE bound."""
from torch_matcher_e2e import ATE_BOUND, run_ate


def test_ndt_gicp_e2e():
    """Type 3, the NdtWithGicp chain (ndt_gicp.cc:55-112)."""
    ate = run_ate(3)
    assert ate < ATE_BOUND[3], f"NdtWithGicp e2e ATE {ate}"
