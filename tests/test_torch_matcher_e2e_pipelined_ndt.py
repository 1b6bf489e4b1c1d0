"""tests/test_matcher_e2e.py's NDT (type 5) run through the port's chunked
front end on the CPU, under that file's ATE bound."""
from torch_matcher_e2e import ATE_BOUND, NDT_SCANS, run_ate


def test_pipelined_ndt_e2e():
    """Type 5 through the chunked device front end."""
    ate = run_ate(5, pipelined=True, **NDT_SCANS)
    assert ate < ATE_BOUND[5], f"pipelined Ndt e2e ATE {ate}"
