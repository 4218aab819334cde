"""Nothing that runs on the card loads JAX or the JAX package, compared by
whole top-level module name (the port's name starts with the JAX
package's), and the yardstick imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "vats_tpu"}
#: the yardstick: what decides correct and counts work reads nothing of the program
YARDSTICK = ("reference", "traffic.py", "weights.py", "work.py", "metrics")


def _sources(*under):
    for top in under or ("",):
        path = os.path.join(BENCH, top)
        if os.path.isfile(path):
            yield path
            continue
        for d, dirs, files in os.walk(path):
            dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_of_the_harness_imports_jax(path):
    assert not FORBIDDEN & set(_top_names(path))


@pytest.mark.parametrize("path", sorted(_sources(*YARDSTICK)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "vats_tpu_torch" not in set(_top_names(path))


def test_a_run_loads_no_jax_module():
    """Everything a run imports, the port's modules included, in a fresh
    interpreter."""
    code = """
import sys
sys.argv = ["run"]
import benchmark.run, benchmark.control, benchmark.sweep
from benchmark.drivers import serve, train
from benchmark import harness
import os
for f in os.listdir(os.path.join(harness.HERE, "metrics")):
    if f.endswith(".py"):
        harness.load_reader(f[:-3])
import vats_tpu_torch.inference.serving, vats_tpu_torch.inference.quantize
import vats_tpu_torch.train, vats_tpu_torch.data.feed, vats_tpu_torch.ops.kernels
import vats_tpu_torch.models.text_lm, torch.profiler
print(",".join(harness.forbidden_modules()))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_check_compares_whole_top_level_names():
    from benchmark import harness

    names = ["vats_tpu_torch", "vats_tpu_torch.inference.serving", "vats_tpu.models", "jaxlib.xla",
             "jax", "flax.linen", "flaxen", "jaxtyping"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib.xla",
                                                "vats_tpu.models"]
