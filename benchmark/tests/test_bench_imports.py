"""What the benchmark and its reference import: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "robustpointclouds_tpu"}
PORT = "robustpointclouds_tpu_torch"


def _sources():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _top_levels(path):
    """Top-level names of the absolute imports of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    bad = [(p, n) for p in _sources() if "/tests/" not in p
           for n in _top_levels(p) if n in FORBIDDEN]
    assert bad == []


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    bad = [(p, n) for p in _sources() if p.startswith(ref + os.sep)
           for n in _top_levels(p) if n in FORBIDDEN | {PORT, "benchmark"}]
    assert bad == []


def _loaded(modules):
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, USE_FLAX="0", USE_JAX="0"))
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port_or_jax():
    loaded = _loaded(["benchmark.reference.second", "benchmark.reference.train",
                      "benchmark.reference.optim"])
    assert not loaded & (FORBIDDEN | {PORT})


@pytest.mark.parametrize("family", ["second"])
def test_the_harness_loads_the_port_and_no_jax(family):
    loaded = _loaded(["benchmark.harness", "benchmark.counts", f"benchmark.program.{family}",
                      "benchmark.entries.train_inline", "benchmark.entries.attack_eval_inline"])
    assert PORT in loaded and not loaded & FORBIDDEN
