"""BENCHMARK.json parses and keeps the naming rules, every name it gives
leads to its file, and a new configuration, traffic mix, cell, output
check and metric are found with no edit to a file that is there."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from mapbench import manifest

ROOT = manifest.ROOT
BENCH = manifest.load(ROOT)


def test_names_and_units_are_allowed():
    assert manifest.check_names(BENCH) == []


def test_every_name_leads_to_its_file():
    for w in BENCH["workloads"]:
        parts = manifest.cell(BENCH, w["name"], ROOT)
        assert parts["config"]["points_per_scan"] <= parts["config"][
            "settings"]["map_builder.front_end.scan_capacity"]
        for m in manifest.checks(parts["cell"], ROOT).values():
            assert callable(m.collect) and callable(m.numbers)
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert callable(manifest.reader(m["name"]).read)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        names = {m["name"] for m in manifest.metrics_of(BENCH, w["name"],
                                                        "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.metrics_of(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "mapbench")):
        for f in files:
            if f.endswith((".py", ".json", ".xml")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


DUMMY_CHECK = """from ..reference import mapping


def collect(mb, period):
    return {"scans": 3 * period}


def numbers(data, run):
    return {"dummy_number": data["scans"] + run.window[1] - run.window[0]}
"""


def test_new_config_traffic_cell_and_metric_need_no_edit(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "mapbench"),
                    os.path.join(root, "mapbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root)
    w = BENCH["workloads"][0]
    cfg = manifest.cell(BENCH, w["name"], ROOT)
    files = {
        "configs/dummy_config.json": dict(cfg["config"], points_per_scan=7),
        "traffic/dummy_mix.json": dict(cfg["traffic"], step_m=0.7),
        "cells/dummy_cell.json": dict(
            cfg["cell"], window_scans_per_s=1.0, checks=["dummy_check"],
            limits=dict(cfg["cell"]["limits"], dummy_number=10.0)),
    }
    for rel, body in files.items():
        with open(os.path.join(root, "mapbench", rel), "w") as f:
            json.dump(body, f)
    with open(os.path.join(root, "mapbench/metrics/dummy_metric.py"),
              "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    with open(os.path.join(root, "mapbench/checks/dummy_check.py"),
              "w") as f:
        f.write(DUMMY_CHECK)
    bench = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "a test", "moves": "scans_per_s",
                               "workloads": ["dummy_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    probe = (
        "import json\n"
        "from mapbench import check, manifest\n"
        "b = manifest.load('.')\n"
        "c = manifest.cell(b, 'dummy_cell', '.')\n"
        "m = [x['name'] for x in manifest.metrics_of(b, 'dummy_cell', "
        "'per_layer')]\n"
        "k = manifest.checks(c['cell'], '.')['dummy_check']\n"
        "run = check.run_of(None, {}, (5, 9), 0, 0, None, None, 1, 'cpu')\n"
        "print(json.dumps([c['config']['points_per_scan'], "
        "c['traffic']['step_m'], c['cell']['window_scans_per_s'], m, "
        "manifest.reader('dummy_metric').read(None), "
        "manifest.reader('dummy_metric').__file__, "
        "check.judge(k.numbers(k.collect(None, 0.5), run), "
        "{'dummy_number': c['cell']['limits']['dummy_number']}), "
        "k.__file__, manifest.check_names(b, '.')]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    (pts, step, rate, metrics, value, path, judged, check_path,
     bad) = json.loads(out)
    assert (pts, step, rate, value) == (7, 0.7, 1.0, 42.0)
    assert "dummy_metric" in metrics
    assert judged == [True, {"dummy_number": {"value": 5.5, "limit": 10.0}}]
    assert bad == []
    for p in (path, check_path):
        assert os.path.realpath(p).startswith(os.path.realpath(root))
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
