"""The rate and the device's idle share from hand-made numbers and event
lists, a window with a stall among them."""
import pytest

from mapbench import drive, trace
from mapbench.metrics import (device_idle_pct, launches_per_scan,
                              nn_ms_per_scan, scans_per_s)

W = (1000.0, 11000.0)        # a 10 ms window, in microseconds


def _ctx(events, scans=4):
    ctx = drive.Context()
    ctx.window_scans = ctx.trace_scans = scans
    ctx.trace = trace.reduce_events(events, W)
    return ctx


def test_rate_is_all_scans_over_all_the_window():
    ctx = drive.Context()
    ctx.window_scans, ctx.window_s = 320, 25.0
    assert scans_per_s.read(ctx) == pytest.approx(12.8)


def test_idle_share_with_a_stall():
    events = [
        ("insert_pointcloud", 1000.0, 11000.0, False),
        ("aten::mm", 1500.0, 1600.0, False),
        ("time.sleep", 3000.0, 9000.0, False),
        ("void nn_main<2, 256>(float const*)", 1000.0, 2000.0, True),
        ("void nn_merge(float const*)", 1500.0, 2500.0, True),   # overlaps
        ("elementwise_kernel", 2900.0, 3000.0, True),
        ("Memcpy DtoH (Device -> Pinned)", 9000.0, 10000.0, True),
        ("elementwise_kernel", 10500.0, 12000.0, True),       # past the end
        ("elementwise_kernel", 100.0, 900.0, True),            # before it
    ]
    ctx = _ctx(events)
    # busy: [1000, 2500] + [2900, 3000] + [9000, 10000] + [10500, 11000]
    assert ctx.trace["busy_s"] == pytest.approx(3.1e-3)
    assert ctx.trace["window_s"] == pytest.approx(10e-3)
    assert device_idle_pct.read(ctx) == pytest.approx(69.0)
    # the stall is the longest gap, named by the host op under it
    name, length = ctx.trace["idle_gaps"][0]
    assert length == pytest.approx(6e-3)
    assert name == "insert_pointcloud / time.sleep"
    assert launches_per_scan.read(ctx) == pytest.approx(4 / 4)
    assert nn_ms_per_scan.read(ctx) == pytest.approx(2.0 / 4)


def test_no_device_events_reads_nothing():
    ctx = _ctx([("aten::mm", 1500.0, 1600.0, False)])
    assert device_idle_pct.read(ctx) is None
    assert launches_per_scan.read(ctx) is None
    assert nn_ms_per_scan.read(ctx) is None
