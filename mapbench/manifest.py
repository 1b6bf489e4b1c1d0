"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The harness finds:

- ``mapbench/configs/<config>.json``: the configuration (points a scan,
  the settings put on the loaded XML, whether the back end runs);
- ``mapbench/traffic/<traffic>.json``: the mix's parameters, read by the
  one generator (``generator.py``);
- ``mapbench/cells/<workload>.json``: the cell's window size and the
  limits of its output check, and optionally ``"checks": [<name>, ...]``,
  the cell's own output checks;
- ``mapbench/checks/<name>.py``: one such check, found under the same
  root as the cell file (``checks``).  It gives ``collect(mb, period)``,
  ``numbers(data, run)`` and optionally ``control(run)``; ``check.py``
  says what each gets and when it is called;
- ``mapbench/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer.

Adding a configuration, a mix, a cell, an output check or a metric adds
files and entries and edits none that is there.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def check_names(bench: dict, root: str = ROOT) -> List[str]:
    """What in ``bench`` breaks the naming rules: every name, config,
    traffic and reduced key a name, and each name in the ``checks`` of a
    cell file under ``root``, every unit a unit, every ``why``,
    ``source`` and ``layer`` one line of at most 200 characters, no name
    twice."""
    bad = []

    def name(v, where):
        if not (isinstance(v, str) and NAME_RE.match(v)):
            bad.append(f"{where}: {v!r} is not a name")

    for c in bench.get("configs", []):
        name(c.get("name"), "configs")
        for k in c.get("reduced", []):
            name(k, f"configs[{c.get('name')}].reduced")
    for w in bench.get("workloads", []):
        for key in ("name", "config", "traffic"):
            name(w.get(key), f"workloads.{key}")
        path = os.path.join(root, "mapbench", "cells",
                            f"{w.get('name')}.json")
        if NAME_RE.match(str(w.get("name"))) and os.path.isfile(path):
            with open(path) as f:
                own = json.load(f).get("checks", [])
            for n in own:
                name(n, f"cells[{w['name']}].checks")
            bad += [f"cells[{w['name']}].checks: {n!r} twice"
                    for i, n in enumerate(own) if n in own[:i]]
    for group in ("end_to_end", "per_layer"):
        for m in bench.get(group, []):
            name(m.get("name"), group)
            if not (isinstance(m.get("unit"), str)
                    and UNIT_RE.match(m["unit"])):
                bad.append(f"{group}[{m.get('name')}]: unit {m.get('unit')!r}")
    for group, key in (("configs", "why"), ("configs", "source"),
                       ("workloads", "why"), ("per_layer", "layer")):
        for e in bench.get(group, []):
            v = e.get(key)
            if not (isinstance(v, str) and 1 <= len(v) <= 200
                    and "\n" not in v and "\t" not in v):
                bad.append(f"{group}[{e.get('name')}].{key}: not one line "
                           "of 1 to 200 characters")
    for group in ("configs", "workloads"):
        names = [e.get("name") for e in bench.get(group, [])]
        bad += [f"{group}: {n!r} twice" for n in set(names)
                if names.count(n) > 1]
    metrics = [m.get("name") for g in ("end_to_end", "per_layer")
               for m in bench.get(g, [])]
    bad += [f"metrics: {n!r} twice" for n in set(metrics)
            if metrics.count(n) > 1]
    return bad


def _json(kind: str, name: str, root: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} {name!r} is not a name")
    with open(os.path.join(root, "mapbench", kind, name + ".json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: str = ROOT) -> Dict[str, dict]:
    """The cell's manifest entry, configuration, traffic and cell file."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    return {"workload": w,
            "config": _json("configs", w["config"], root),
            "traffic": _json("traffic", w["traffic"], root),
            "cell": _json("cells", workload, root)}


def checks(cell: dict, root: str = ROOT) -> Dict[str, object]:
    """The cell's own output checks by name: the module
    ``mapbench/checks/<name>.py`` under ``root`` for each name in the cell
    file's ``checks`` (none where it has no such key).  Dots and dashes of
    a name are underscores in the file's name, as for a metric's reader."""
    out = {}
    for name in cell.get("checks", []):
        if not (isinstance(name, str) and NAME_RE.match(name)):
            raise ValueError(f"check {name!r} is not a name")
        if name in out:
            raise ValueError(f"check {name!r} named twice")
        mod = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"mapbench.checks.{mod}",
            os.path.join(root, "mapbench", "checks", mod + ".py"))
        module = importlib.util.module_from_spec(spec)
        # registered before it runs, as an import would, so that what
        # looks a module up by name (dataclasses, pickle) finds it
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        out[name] = module
    return out


def metrics_of(bench: dict, workload: str, group: str) -> List[dict]:
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those with no ``workloads`` key, and those that list
    it."""
    return [m for m in bench[group]
            if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The reader module ``mapbench.metrics.<metric>``; metric names may
    hold dots, which the module's file name keeps as underscores."""
    if not NAME_RE.match(metric):
        raise ValueError(f"metric {metric!r} is not a name")
    mod = metric.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"mapbench.metrics.{mod}")
