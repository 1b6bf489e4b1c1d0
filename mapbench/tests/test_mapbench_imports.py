"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and a cell's own output checks import nothing of the program;
names compare by their whole top-level part (the port's name begins with
the JAX package's)."""
import ast
import os
import subprocess
import sys

import pytest

from mapbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "staticmapping_tpu"}
PROGRAM = "staticmapping_torch"


def _sources(sub=""):
    base = os.path.join(manifest.HERE, sub)
    out = []
    for d, _, files in os.walk(base):
        if os.sep + "tests" in d[len(manifest.HERE):]:
            continue
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_no_jax(path):
    assert not set(_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference") + _sources("checks"),
                         ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_roots(path))
    src = open(path).read()
    assert "import_module" not in src and "__import__" not in src


def test_top_level_names_compare_whole():
    from mapbench import run
    assert "staticmapping_torch".split(".")[0] not in run.FORBIDDEN
    assert "staticmapping_tpu" in run.FORBIDDEN


def test_harness_and_program_load_no_jax():
    probe = ("import sys\n"
             "import mapbench.run, mapbench.drive, mapbench.control\n"
             "import mapbench.reference.mapping, mapbench.checks\n"
             "import staticmapping_torch.config\n"
             "from mapbench import run\n"
             "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=manifest.ROOT,
                         check=True, capture_output=True, text=True).stdout
    assert out.strip() == "[]"
