"""The chunked front end's profilers (``scripts/torch_profile_floor.py``,
``scripts/torch_profile_chunk_ablate.py``) run on the CPU at a tiny size:
4-scan chunks of 2048 slots, 1500 points a scan."""
import math

import pytest
import torch

from scripts import torch_profile_chunk_ablate as ablate
from scripts import torch_profile_floor as floor

CPU = "cpu"
TINY = dict(capacity=2048, max_points=1500, chunk=4)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_floor_times_every_stage():
    out = floor.run(CPU, n_scans=12, reps=1, **TINY)
    for key in ("pack_ms", "h2d_ms", "run_chunk_floor_ms",
                "run_chunk_full_ms", "harvest_ms"):
        assert math.isfinite(out[key]) and out[key] >= 0.0, key
    # one int16 xyzi row a slot and one f32 meta row a scan
    assert out["h2d_bytes"] == 4 * (2048 * 4 * 2 + 4 * 4)
    assert out["run_chunk_floor_keyframes"] == 0


def test_ablation_runs_every_variant():
    rows = ablate.run(CPU, n_scans=18, **TINY)
    assert [r["variant"] for r in rows] == [n for n, _ in ablate.variants()]
    for r in rows:
        assert r["ms_per_chunk"] > 0.0 and r["scans_per_s"] > 0.0
    by_name = {r["variant"]: r for r in rows}
    for name in ("nokf", "icp1+nokf", "icp1+nokf+nc"):
        assert by_name[name]["keyframes"] == 0, name


def test_reference_floor_tool_calls_a_chunk_signature_that_is_gone():
    """tools/profile_floor.py calls ``fe._run_chunk`` with six arguments
    (state, stamps, xyz, intensity, mask, valid), but the JAX package's
    ``DeviceFrontEnd`` jits ``_chunk_fn(state, qdata, meta, imu_arr)`` over
    the int16 pack of ``_pack_chunk``: the tool is stale against its own
    package (ROADMAP queue C), so the port's profiler follows today's
    chunk."""
    import ast
    import inspect
    import os
    from staticmapping_tpu.builder import pipeline as jpipeline
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "profile_floor.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    calls = [len(node.args) for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", "") == "_run_chunk"]
    params = list(inspect.signature(
        jpipeline.DeviceFrontEnd._chunk_fn).parameters)[1:]
    assert calls and set(calls) == {6}
    assert params == ["state", "qdata", "meta", "imu_arr"]
