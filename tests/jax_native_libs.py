"""Build the JAX package's two native libraries once, under a lock between processes.

robustpointclouds_tpu/data/native_plan.py (`libplan.so`) and data/native.py
(`libpointcloud.so`) compile with g++ straight into build/ and guard the
build with a thread lock only. Under pytest-xdist, N worker processes reach
them at once in a fresh checkout: one worker loads the file another is
still writing, `ctypes.CDLL` raises, and the module keeps `_build_failed`
(native_plan) or re-raises (native) for the rest of that worker's life, so
every later test of that worker that reaches the builder fails.

The port's test files that reach those builders import this module at
module level. Every xdist worker collects the whole suite before any test
runs, so `load_jax_native_libs()` runs in each worker at collection: the
first takes an `fcntl.flock` on a lock file in the build directory and
builds, the others wait and then load the finished file. A load that fails
(a torn file left by an unlocked builder) deletes the `.so`, resets the
module's cached state and builds once more under the lock; a second failure
raises. The JAX package itself is not changed.
"""
import fcntl
import os
from typing import Optional

from robustpointclouds_tpu.data import native, native_plan

_MODULES = (native_plan, native)


def _load(mod):
    try:
        return mod.get_lib()
    except OSError:  # native.get_lib re-raises ctypes' error on a torn file
        return None


def _reset(mod) -> None:
    mod._lib = None
    mod._build_failed = False


def load_jax_native_libs(build_dir: Optional[str] = None) -> None:
    """Load (building if needed) both libraries in this process, under a
    lock on `<build dir>/.jax_native_libs.lock` shared by every process.
    `build_dir`: where both modules build (their own `_BUILD_DIR` by
    default); given, the modules' `_BUILD_DIR` and `_SO` are pointed there
    and their cached libraries dropped."""
    if build_dir is not None:
        for mod in _MODULES:
            mod._BUILD_DIR = build_dir
            mod._SO = os.path.join(build_dir, os.path.basename(mod._SO))
            _reset(mod)
    lock_dir = _MODULES[0]._BUILD_DIR
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, ".jax_native_libs.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for mod in _MODULES:
                if _load(mod) is not None:
                    continue
                if os.path.exists(mod._SO):
                    os.remove(mod._SO)
                _reset(mod)
                if _load(mod) is None:
                    raise RuntimeError(f"{mod.__name__}: {mod._SO} did not build or load twice "
                                       "under the lock")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


load_jax_native_libs()
