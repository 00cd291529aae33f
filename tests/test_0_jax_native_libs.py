"""The JAX package's native libraries, built under the lock before any test file is collected.

tests/test_native.py and tests/test_native_plan.py call the JAX builders
(`native.native_available()`, `native_plan.native_plan_available()`) in a
`skipif` at collection. Those builders compile with g++ straight into
build/ under a thread lock only, so in a fresh checkout the xdist workers
race there: one loads the file another is still writing, and either its
collection errors (`native.get_lib` re-raises ctypes' error) or the plan
file's tests skip in that worker. This file sorts before every other test
file; it imports tests/jax_native_libs.py at module level, so each worker
builds, or waits for the build, under the `fcntl.flock` before any JAX
test file calls a builder.

`test_fresh_checkout_under_xdist` replays the tier-1 command line (`-n 6
--dist loadfile`) on a copy of the committed files with an empty build/,
limited to this file (less that test) and the two JAX native test files.
"""
import os
import re
import shutil
import subprocess
import sys

import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from robustpointclouds_tpu.data import native, native_plan

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# the copy: the JAX package, its C++ sources and the test files the run needs
_COPY_DIRS = ("robustpointclouds_tpu", "csrc")
_COPY_TESTS = ("conftest.py", "jax_native_libs.py", "test_0_jax_native_libs.py",
               "test_native.py", "test_native_plan.py")
_FILES = ("tests/test_0_jax_native_libs.py", "tests/test_native.py", "tests/test_native_plan.py")
# 1 here + 5 in test_native.py + 7 of test_native_plan.py's 8 (one is in the
# heavy tier, tests/conftest.py, and skips)
_EXPECTED = {"passed": 13, "skipped": 1}
_RUN_TIMEOUT_S = 600


def test_both_jax_libraries_loaded():
    assert native_plan._lib is not None and not native_plan._build_failed
    assert native._lib is not None and not native._build_failed
    assert hasattr(native_plan._lib, "rpc_build_plan") and hasattr(native._lib, "rpc_load_points")


def _copy_tree(dst: str) -> None:
    """The JAX package, csrc/ and the run's test files, without build outputs."""
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "build", ".pytest_jax_cache")
    for d in _COPY_DIRS:
        shutil.copytree(os.path.join(REPO, d), os.path.join(dst, d), ignore=skip)
    os.makedirs(os.path.join(dst, "tests"))
    for f in _COPY_TESTS:
        shutil.copy2(os.path.join(TESTS, f), os.path.join(dst, "tests", f))


def test_fresh_checkout_under_xdist(tmp_path):
    """Six xdist workers collect the JAX native test files in a checkout
    whose build/ is empty: no collection error, every test passes."""
    root = str(tmp_path / "checkout")
    _copy_tree(root)
    assert not os.path.exists(os.path.join(root, "build"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "XDIST_")) and k not in ("PYTHONPATH",
                                                                      "RPC_HEAVY_TESTS")}
    env.update(JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    cmd = [sys.executable, "-m", "pytest", *_FILES, "-q", "-m", "not slow",
           "--continue-on-collection-errors", "-p", "no:cacheprovider", "-p", "xdist",
           "-n", "6", "--dist", "loadfile", "-p", "no:randomly",
           # this test itself is not run in the copy: it would recurse
           "--deselect", "tests/test_0_jax_native_libs.py::test_fresh_checkout_under_xdist"]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                          timeout=_RUN_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert not re.search(r"\d+ errors?\b", out) and "ERROR collecting" not in out, out[-4000:]
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|skipped|failed)", out)}
    assert counts == _EXPECTED, out[-4000:]
    assert sorted(f for f in os.listdir(os.path.join(root, "build")) if f.endswith(".so")) == [
        "libplan.so", "libpointcloud.so"]
