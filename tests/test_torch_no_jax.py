"""The PyTorch port stands alone: no module of ``staticmapping_torch``, not
``chip_smoke.py``, not the GPU tests (which run where JAX is not
installed) and not the multi-device test's ranks import JAX or the JAX
package, and importing the port in a fresh
interpreter loads neither."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "staticmapping_tpu")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "main_path.py"),
             os.path.join(ROOT, "scripts", "backend_path_frames.py"),
             os.path.join(ROOT, "scripts", "nn_kernel_times.py"),
             os.path.join(ROOT, "scripts", "torch_cli_ate.py"),
             os.path.join(ROOT, "scripts", "torch_matcher_ate.py"),
             os.path.join(ROOT, "scripts", "torch_sensor_ate.py"),
             os.path.join(ROOT, "scripts", "torch_eval_rows.py"),
             os.path.join(ROOT, "scripts", "torch_experiment_verifier.py"),
             os.path.join(ROOT, "scripts", "torch_profile_floor.py"),
             os.path.join(ROOT, "scripts", "torch_profile_chunk_ablate.py"),
             os.path.join(ROOT, "tests", "test_torch_cuda.py"),
             os.path.join(ROOT, "tests", "torch_multidevice_worker.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "staticmapping_torch")):
        paths += [os.path.join(dirpath, f) for f in sorted(files)
                  if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_import_loads_no_jax():
    # modules loaded before the port (a site hook may preload some) are
    # not the port's doing
    code = ("import sys, importlib, pkgutil\n"
            "before = set(sys.modules)\n"
            "import staticmapping_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(k for k in set(sys.modules) - before\n"
            f"             if k.split('.')[0] in {FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=False,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_main_path_settings_load_neither_torch_nor_jax():
    """The JAX reference script shares the main path's settings without
    needing torch."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import scripts.main_path\n"
            "print(sorted({k.split('.')[0] for k in set(sys.modules) - before}\n"
            "             & {'torch', 'jax', 'staticmapping_tpu',\n"
            "                'staticmapping_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=False,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
