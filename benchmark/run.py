"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The last line of standard output is the
result's JSON object; the compared numbers and their limits are the last
lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices, or when JAX or the JAX package was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "robustpointclouds_tpu")
CACHE = os.path.join(ROOT, "build", "benchmark_cache")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(cfg_env: dict) -> None:
    """Fixed caches inside the checkout; no JAX through a library; the
    program's gated modes as the configuration states them."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ.update(cfg_env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the package from the checkout's root, never this folder's modules as top-level names
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != here]

    from benchmark import harness

    bench = harness.spec()
    wl = harness.workload(args.workload, bench)
    cfg, _, _ = harness.cell_parts(wl, bench)
    set_environment(cfg.get("env", {}))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                      bench=bench)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    harness.report_checks(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
