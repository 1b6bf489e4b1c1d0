"""A scan without a keyframe counts as missed only where the reference's
step, from the same start, makes one."""
import numpy as np

from mapbench import check, generator, manifest

BENCH = manifest.load()


def _drive(n=6):
    parts = manifest.cell(BENCH, "vlp16_straight")
    cfg = parts["config"]["reference"]
    cfg = dict(cfg, scan_capacity=16384)
    poses, scans = generator.render_drive(parts["traffic"], 16000, 16384, n,
                                          11, "cpu")
    return cfg, poses, scans


def test_a_scan_that_moved_is_missed():
    cfg, poses, scans = _drive()
    frames = {k: poses[k] for k in (0, 1, 2, 3, 5)}
    assert check.keyframes_missed(scans, frames, [4], cfg, "cpu") == 1


def test_a_scan_that_did_not_move_is_not_missed():
    cfg, poses, scans = _drive()
    scans = scans.copy()
    scans[4] = scans[3]          # the sensor stood still
    frames = {k: poses[k] for k in (0, 1, 2, 3, 5)}
    assert check.keyframes_missed(scans, frames, [4], cfg, "cpu") == 0


def test_a_scan_with_no_start_is_missed():
    cfg, poses, scans = _drive()
    frames = {k: poses[k] for k in (0, 1, 4, 5)}
    assert check.keyframes_missed(scans, frames, [2, 3], cfg, "cpu") == 2
