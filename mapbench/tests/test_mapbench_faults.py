"""A run of a small cell on the CPU, the chip's look skipped, with the
timed path broken underneath: the output check comes out not correct for
each fault the cells can have, and correct with the path whole.  A cell's
own output checks are judged with the core ones.

The small cell is the VLP-16 configuration at fewer points a scan, 8-scan
chunks and pair-match batches of 4, held to ``vlp16_straight``'s limits.
Each run takes about a minute and a half."""
import json
import os
import time

import pytest
import torch

from mapbench import drive, manifest

HELD_TO = "vlp16_straight"
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("small"))
    bench = manifest.load()
    parts = manifest.cell(bench, HELD_TO)
    cfg = parts["config"]
    cfg["points_per_scan"] = 16000
    for key, value in (("map_builder.front_end.scan_capacity", 16384),
                       ("map_builder.submap_capacity", 32768),
                       ("map_builder.pipeline_chunk", 8),
                       ("map_builder.pair_match_batch", 4)):
        cfg["settings"][key] = value
    cfg["reference"].update(scan_capacity=16384, submap_capacity=32768)
    traffic = dict(parts["traffic"], warmup_scans=41)
    cell = dict(parts["cell"], window_scans_per_s=12.0)
    cell["check"] = {"frontend_samples": 6, "pair_samples": 4}
    for kind, body in (("configs", cfg), ("traffic", traffic),
                       ("cells", cell)):
        os.makedirs(os.path.join(root, "mapbench", kind))
        with open(os.path.join(root, "mapbench", kind, "small.json"),
                  "w") as f:
            json.dump(body, f)
    bench["workloads"] = [{"name": "small", "config": "small",
                           "traffic": "small", "chips": 1, "why": "a test"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _run(root, bench=None, workload="small"):
    return drive.run_cell(bench or manifest.load(root), workload, SEED, 4.0,
                          False, "cpu", time.perf_counter(), root)


def _icp_returns_guess(monkeypatch):
    """The front end's ICP returns its state unchanged: the guess.  From
    the first scan on, that guess is no motion, so no scan becomes a
    keyframe."""
    from staticmapping_torch.builder import pipeline

    def align(src, target, guess, **kw):
        return guess, torch.ones((), device=guess.device)
    monkeypatch.setattr(pipeline, "align_point_to_plane", align)


def _half_pair_batch(monkeypatch):
    """Half of each pair-match batch left out, the mean of the other
    half's transforms and scores taken for it."""
    from staticmapping_torch.builder import map_builder
    orig = map_builder._batch_pair_align

    def align(sources, targets, guesses, *a, **kw):
        h = (len(sources) + 1) // 2
        T, s = orig(sources[:h], targets[:h], guesses[:h], *a, **kw)
        rest = len(sources) - h
        return (torch.cat([T, T.mean(0, keepdim=True).expand(rest, 4, 4)]),
                torch.cat([s, s.mean().expand(rest)]))
    monkeypatch.setattr(map_builder, "_batch_pair_align", align)


def _answer_altered(monkeypatch):
    """Every front-end registration moved by 3 cm where it is made."""
    from staticmapping_torch.builder import pipeline
    orig = pipeline.align_point_to_plane

    def align(*a, **kw):
        T, s = orig(*a, **kw)
        T = T.clone()
        T[..., 0, 3] += 0.03
        return T, s
    monkeypatch.setattr(pipeline, "align_point_to_plane", align)


FAULTS = {"icp_returns_guess": (_icp_returns_guess, "missing_keyframes"),
          "half_pair_batch": (_half_pair_batch, "pair_score_gap"),
          "answer_altered": (_answer_altered, "frontend_gap_mm")}


def test_whole_path_is_correct(small_root):
    res = _run(small_root)
    print("whole", res["checks"])
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(small_root, monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res = _run(small_root)
    print(fault, res["checks"])
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_control_is_caught(small_root):
    """The reference with TF32 products in the program's place fails the
    held cell's limits (on the chip, at the cells' own sizes, it runs as
    ``python3 -m mapbench.control``)."""
    from mapbench import check, control
    bench = manifest.load(small_root)
    res = control.control_numbers(bench, "small", SEED, 4.0, "cpu",
                                  small_root)
    correct, checks = check.judge(res["numbers"], res["limits"])
    print("control", checks)
    assert not correct
    assert checks["frontend_gap_mm"]["value"] > checks[
        "frontend_gap_mm"]["limit"], checks


OWN_CHECKS = {
    # a number within its limit, read through what collect and run give
    "own_window": ("def collect(mb, period):\n"
                   "    return {'period': period}\n"
                   "def numbers(data, run):\n"
                   "    return {'own_window_scans': float(run.window[1]"
                   " - run.window[0]) if data['period'] == 0.1 else -1.0}\n"),
    # a number over its limit: the builder holds submaps
    "own_over": ("def collect(mb, period):\n"
                 "    return {'submaps': len(mb.trajectory)}\n"
                 "def numbers(data, run):\n"
                 "    return {'own_submaps': float(data['submaps'])}\n"),
    # no number for its limit
    "own_none": ("def collect(mb, period):\n"
                 "    return {}\n"
                 "def numbers(data, run):\n"
                 "    return {}\n"),
    # a number under a core check's name
    "own_clash": ("def collect(mb, period):\n"
                  "    return {}\n"
                  "def numbers(data, run):\n"
                  "    return {'frontend_gap_mm': 0.0}\n"),
}
OWN_CASES = {"over": (["own_window", "own_over"],
                      {"own_window_scans": 48, "own_submaps": 0}),
             "none": (["own_none"], {"own_none_number": 1e9}),
             "clash": (["own_clash"], {})}


def _own_cell(root, workload, sources, limits):
    """The small cell, under the name ``workload``, naming the checks of
    ``sources`` (name: module source) with ``limits`` added; its file and
    the checks' are new files under ``root``.  The benchmark with it."""
    os.makedirs(os.path.join(root, "mapbench", "checks"), exist_ok=True)
    for name, source in sources.items():
        with open(os.path.join(root, "mapbench", "checks", name + ".py"),
                  "w") as f:
            f.write(source)
    bench = manifest.load(root)
    cell = manifest.cell(bench, "small", root)["cell"]
    cell = dict(cell, checks=list(sources),
                limits=dict(cell["limits"], **limits))
    with open(os.path.join(root, "mapbench", "cells", workload + ".json"),
              "w") as f:
        json.dump(cell, f)
    bench["workloads"].append(dict(bench["workloads"][0], name=workload))
    return bench


@pytest.mark.parametrize("case", sorted(OWN_CASES))
def test_own_check_is_judged(small_root, case):
    """A cell's own check, a file under ``mapbench/checks/``: its number
    over its limit reads not correct beside the limit, as does a limit
    with no number, and a number under a core check's name stops the
    run."""
    names, limits = OWN_CASES[case]
    workload = f"small_{case}"
    bench = _own_cell(small_root, workload,
                      {n: OWN_CHECKS[n] for n in names}, limits)
    if case == "clash":
        with pytest.raises(ValueError, match="check.py.*checks/own_clash"):
            _run(small_root, bench, workload)
        return
    res = _run(small_root, bench, workload)
    print(case, res["checks"])
    assert not res["correct"]
    checks = res["checks"]
    core = ("frontend_gap_mm", "pair_score_gap", "missing_keyframes",
            "missing_pair_matches")
    assert all(checks[n]["value"] <= checks[n]["limit"] for n in core)
    if case == "over":
        assert checks["own_window_scans"] == {"value": 48.0, "limit": 48}
        assert checks["own_submaps"]["value"] > 0
    else:
        assert checks["own_none_number"] == {"value": None, "limit": 1e9}


def test_own_control_is_printed(small_root):
    """The control prints the numbers of a cell's own check that gives a
    ``control`` beside the core ones, with ``run`` as the check's own
    numbers get it."""
    from mapbench import control
    bench = _own_cell(small_root, "small_control", {"own_control": (
        "def collect(mb, period):\n"
        "    return {}\n"
        "def numbers(data, run):\n"
        "    return {}\n"
        "def control(run):\n"
        "    return {'own_control_frames': float(len(run.outputs['frames'])),"
        " 'own_control_window': float(run.window[0])}\n")}, {})
    res = control.control_numbers(bench, "small_control", SEED, 4.0, "cpu",
                                  small_root)
    core = control.control_numbers(bench, "small", SEED, 4.0, "cpu",
                                   small_root)
    # the drive's 41 warm-up and 48 window scans, less the last two chunks
    assert res["numbers"] == dict(core["numbers"],
                                  own_control_frames=41 + 48 - 16,
                                  own_control_window=41.0)
