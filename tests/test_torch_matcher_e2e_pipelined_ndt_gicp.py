"""tests/test_matcher_e2e.py's NdtWithGicp (type 3) run through the port's
chunked front end on the CPU, under that file's ATE bound."""
from torch_matcher_e2e import ATE_BOUND, run_ate


def test_pipelined_ndt_gicp_e2e():
    """Type 3 through the chunked device front end."""
    ate = run_ate(3, pipelined=True)
    assert ate < ATE_BOUND[3], f"pipelined NdtWithGicp e2e ATE {ate}"
