"""tests/jax_native_libs.py: the JAX package's native libraries built once under a
lock when several processes reach them at once, and rebuilt over a torn file.

Each case runs fresh Python processes whose two JAX builder modules point
at an empty build directory under tmp_path, so the build really happens in
the race (the repo's build/ is not touched).
"""
import os
import subprocess
import sys
import time

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

_CHILD = r"""
import os, sys, time
sys.path.insert(0, {tests!r})
import jax_native_libs as h
from robustpointclouds_tpu.data import native, native_plan
build, go = sys.argv[1], sys.argv[2]
open(sys.argv[3], "w").close()  # ready: imported, about to race
deadline = time.time() + 120
while not os.path.exists(go):
    if time.time() > deadline:
        raise SystemExit("no start signal")
    time.sleep(0.005)
h.load_jax_native_libs(build)
assert native_plan._lib is not None and not native_plan._build_failed
assert native._lib is not None and not native._build_failed
assert native_plan._SO.startswith(build) and native._SO.startswith(build)
assert hasattr(native_plan._lib, "rpc_build_plan") and hasattr(native._lib, "rpc_load_points")
print("loaded")
"""


def _race(tmp_path, n):
    build = str(tmp_path / "build")
    go = str(tmp_path / "go")
    ready = [str(tmp_path / f"ready{i}") for i in range(n)]
    code = _CHILD.format(tests=TESTS)
    procs = [subprocess.Popen([sys.executable, "-c", code, build, go, r], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in ready]
    try:
        deadline = time.time() + 120
        while not all(os.path.exists(r) for r in ready):
            assert time.time() < deadline, "the children did not start"
            assert all(p.poll() is None for p in procs), [p.communicate()[0] for p in procs]
            time.sleep(0.01)
        open(go, "w").close()
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return build, [(p.returncode, out) for p, out in zip(procs, outs)]


def test_four_processes_load_both_libraries_built_at_once(tmp_path):
    build, results = _race(tmp_path, 4)
    for rc, out in results:
        assert rc == 0 and out.strip().endswith("loaded"), out
    assert sorted(f for f in os.listdir(build) if f.endswith(".so")) == [
        "libplan.so", "libpointcloud.so"]


def test_a_torn_library_is_deleted_and_rebuilt(tmp_path):
    """A half-written file newer than its source (what a racing unlocked
    build leaves): the JAX builders load it as is and fail; the helper
    deletes it and builds again."""
    build = tmp_path / "build"
    build.mkdir()
    for name in ("libplan.so", "libpointcloud.so"):
        (build / name).write_bytes(b"\x7fELF torn")
    build_dir, results = _race(tmp_path, 2)
    for rc, out in results:
        assert rc == 0 and out.strip().endswith("loaded"), out
    for name in ("libplan.so", "libpointcloud.so"):
        assert os.path.getsize(os.path.join(build_dir, name)) > 1000
