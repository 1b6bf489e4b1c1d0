"""The output check: what the timed path produced, held to the plain
reference (``mapbench/reference/mapping.py``).

It reads the MapBuilder's outputs once the window has closed: every
keyframe's pose, and every submap's matched transform to its successor.
Every scan of these drives moves more than the motion filter's 0.5 m, so
every scan is a keyframe, and keyframe k's pose relative to k-1's is the
front end's registration of scan k (K1).  From a sample drawn from the
seed it compares:

- ``frontend_gap_mm``: that registration against the reference's, which
  repeats the step from the same inputs (the scans as the benchmark made
  them) and the same start (the two keyframe poses before it, as the
  program output them): the mean distance between a point of scan k
  moved by the one and by the other, the widest over the sample;
- ``pair_score_gap``: for a submap's match to its predecessor (K2), the
  widest difference between the program's score of the match (exp of
  minus the mean matched distance) and the reference's, the reference
  merging both submaps from their scans at the program's keyframe poses.
  The score, and not the stored transform, is compared: under the
  acceptance score (0.7) the stored transform is the guess, and on these
  drives most matches score under it, so a transform would compare the
  guess with itself;
- ``missing_keyframes``: scans of the window harvested by its close
  (all but its last two chunks) without a keyframe where the reference's
  step from the same start makes one; ``missing_pair_matches``: submaps whose match is due and
  absent (both exact, limit 0).

The reference follows the program step by step from the program's own
poses; it reads them, and the answers it judges, and nothing else the
program made.

A cell may bring output checks of its own: its cell file names them
(``"checks": [<name>, ...]``), and each is a module
``mapbench/checks/<name>.py`` (``manifest.checks``).  It imports nothing
of the program; its reference comes from ``mapbench/reference/``.
``drive.run_cell`` calls, for each:

- ``collect(mb, period)`` once the window has closed, right after
  ``drive.program_outputs`` and before the front end is closed and the
  builder freed: it reads attributes of the builder ``mb`` (``period``:
  seconds between scans, a scan's index being its stamp over it) and
  returns host data only (numpy arrays, numbers);
- ``numbers(data, run)`` once the builder is freed and the core numbers
  are taken, under :func:`full_float32`: ``data`` is what ``collect``
  returned, ``run`` the object :func:`run_of` makes; it returns
  ``{name: number}``.

``control.control_numbers`` calls ``control(run)`` where the module gives
it: the module's numbers for the control's answers (the reference put in
the program's place, in TF32), ``run.outputs`` holding the drive's true
poses as the core control's do.  Every number, the core's and the cell's
own, is judged by :func:`judge` against the cell's ``limits``; a name
that two sources give stops the run (:func:`merge`).
"""
from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

from . import generator
from .reference import mapping


def sample_items(seed: int, window, frames: dict, submaps: list,
                 lag: int, pending: int, cell: dict):
    """The sampled scans and submaps of the window, the window's scans
    without a keyframe, and the count of submaps whose match is missing.
    ``frames`` maps scan index to pose; ``submaps`` lists
    ``(scan indices, transform to next or None, score to previous)`` in
    order.  The window's last ``lag`` scans (its last two chunks, one
    staged and one run) are not harvested yet when it closes, and the
    newest ``pending`` submaps may still wait for their match."""
    w0, w1 = window
    due = list(range(w0, w1 - lag))
    missing_kf = [k for k in due if k not in frames]
    fe = [k for k in due if all(j in frames for j in (k, k - 1, k - 2))]
    sub_due = [s for s in range(1, len(submaps) - pending)
               if submaps[s][0] and submaps[s][0][0] >= w0
               and submaps[s - 1][0]]
    missing_pm = sum(1 for s in sub_due if submaps[s - 1][1] is None)
    pm = [s for s in sub_due if submaps[s - 1][1] is not None]
    rng = np.random.default_rng(generator.seed_key(seed, 4))
    n_fe = min(len(fe), cell["check"]["frontend_samples"])
    n_pm = min(len(pm), cell["check"]["pair_samples"])
    fe = sorted(rng.choice(fe, n_fe, replace=False).tolist()) if fe else []
    pm = sorted(rng.choice(pm, n_pm, replace=False).tolist()) if pm else []
    return fe, pm, missing_kf, missing_pm


def keyframes_missed(scans, frames: dict, missing, rcfg: dict,
                     device) -> int:
    """How many of the window's scans without a keyframe (``missing``)
    should have made one: each whose reference step, from the two keyframe
    poses before it, moves past the motion filter's thresholds, and each
    whose two predecessors are not keyframes either, which the reference
    cannot start from."""
    ref = mapping.Precision(torch.float32)
    missed = 0
    with full_float32():
        for k in missing:
            if k - 1 not in frames or k - 2 not in frames:
                missed += 1
                continue
            T = mapping.frontend_step(scans[k - 1], scans[k], frames[k - 2],
                                      frames[k - 1], rcfg, ref, device)[0]
            missed += mapping.is_keyframe(T, rcfg["motion_filter"])
    return missed


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.inv(a) @ b


@contextlib.contextmanager
def full_float32():
    """Matrix products of float32 in full float32 (no TF32), as the
    configuration states, whatever the process had set; restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gaps(scans, frames: dict, submaps: list, fe, pm, rcfg: dict, device,
         control: bool = False) -> dict:
    """Widest front-end gap (mm) and pair-score gap of the answers
    against the reference in float32.  The answers are the
    program's, from ``frames`` and ``submaps``; with ``control`` they are
    the reference's own with TF32 products."""
    ref = mapping.Precision(torch.float32)
    ctl = mapping.Precision(torch.float32, tf32=True)
    fe_gap, sc_gap = [], []
    with full_float32():
        for k in fe:
            step = (scans[k - 1], scans[k], frames[k - 2], frames[k - 1],
                    rcfg)
            T_ref, sx, sm = mapping.frontend_step(*step, ref, device)
            if control:
                T = mapping.frontend_step(*step, ctl, device)[0]
            else:
                T = _rel(frames[k - 1], frames[k])
            fe_gap.append(1e3 * mapping.mean_gap_m(
                sx, sm, T, mapping.normalize_rotation(T_ref)))
        for s in pm:
            a, b = submaps[s][0], submaps[s - 1][0]
            args = ([scans[k] for k in a], [frames[k] for k in a],
                    [scans[k] for k in b], [frames[k] for k in b], rcfg)
            score_ref = mapping.pair_match(*args, ref, device)[1]
            if control:
                score = mapping.pair_match(*args, ctl, device)[1]
            else:
                score = submaps[s][2]
            sc_gap.append(abs(score - score_ref))
    out = {}
    if fe_gap:
        out["frontend_gap_mm"] = max(fe_gap)
    if sc_gap:
        out["pair_score_gap"] = max(sc_gap)
    return out


def run_of(scans, outputs: dict, window, lag: int, pending: int,
           config: dict, cell: dict, seed: int, device):
    """What a cell's own check reads besides its collected data: the
    scans as the benchmark made them, ``drive.program_outputs``' dict, the
    window's first and past-last scan index, the window's last ``lag``
    scans not harvested at its close, the newest ``pending`` submaps that
    may still wait for their match, the configuration and cell files, the
    seed and the device."""
    return types.SimpleNamespace(
        scans=scans, outputs=outputs, window=window, lag=lag,
        pending=pending, config=config, cell=cell, seed=seed, device=device)


def merge(sources: dict) -> dict:
    """The numbers of every source (``{source: {name: number}}``: the
    core check's, each of the cell's own checks') in one dict; a name that
    two sources give is an error that names both."""
    out, origin = {}, {}
    for source, numbers in sources.items():
        for name, v in numbers.items():
            if name in origin:
                raise ValueError(f"check number {name!r} comes from both "
                                 f"{origin[name]} and {source}")
            out[name], origin[name] = v, source
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: each number at or under
    its limit; a number with no limit, or a limit with no number, is not
    correct."""
    out = {}
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, out
