"""Gather-rate probe: the four row-gather kernels, checked and timed on the card.

The counterpart of robustpointclouds_tpu/tools/probe_mosaic_gather.py. Each
gather formulation (kernels/gather.py: row vectors, elements, a row loop,
a one-hot product) is run at the probe's small shape ([512, 128] float32
table, 256 indices) and checked against numpy's x[idx]; then the row and
element gathers are timed at the sparse conv's table size ([96000, 64]
bfloat16, 864000 indices: 9 lookups a row) against the least time the
card's memory allows, the plain PyTorch version and torch.index_select.
Its ns per row and GB/s are the gather rates the sparse-conv kernels'
tiles are chosen from.

    python -m robustpointclouds_tpu_torch.tools.probe_gather [--cpu] [--iters N]

Runs on the card unless `--cpu`, which checks the plain versions at the
small shape and times nothing. Exits 1 if a kernel disagrees.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.gather import (gather_elems, gather_onehot, gather_onehot_ref, gather_ref,
                              gather_row_loop, gather_rows)

SMALL = (512, 128, 256)        # table rows, channels, indices (float32)
SCALE = (96000, 64, 96000 * 9)  # the same at the sparse conv's table size (bfloat16)
HBM_BYTES_PER_S = 3.35e12      # one H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12

# (label, kernel, plain version); the first two are also timed at SCALE
VARIANTS = [("row gather (k_take, kg)", gather_rows, gather_ref),
            ("element gather (k_tal)", gather_elems, gather_ref),
            ("row loop (k_loop)", gather_row_loop, gather_ref),
            ("one-hot product (k_onehot)", gather_onehot, gather_onehot_ref)]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gather_bytes(n: int, c: int, m: int, itemsize: int) -> int:
    """Bytes a gather must move: the output written once, the indices read
    once, the table read once."""
    return m * c * itemsize + m * 4 + n * c * itemsize


def bound_ms(nbytes: float, ops: float = 0.0):
    """(the least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _inputs(shape, dtype, seeds, dev):
    n, c, m = shape
    x = torch.from_numpy(np.random.RandomState(seeds[0]).randn(n, c).astype(np.float32))
    idx = np.random.RandomState(seeds[1]).randint(0, n, m).astype(np.int32)
    return x.to(dtype).to(dev), torch.from_numpy(idx).to(dev)


def probe(dev: torch.device, iters: int = 20) -> Dict[str, List[dict]]:
    """Check every variant at SMALL and, on the card, time them there and
    the row and element gathers at SCALE. Returns {"small": rows, "scale":
    rows}; each row holds the variant's label, kernel name and max_abs_err,
    and on the card ms, plain_ms, library_ms, bound_ms and bound_by."""
    on_card = dev.type == "cuda"
    x, idx = _inputs(SMALL, torch.float32, (0, 1), dev)
    ref = x.cpu().numpy()[idx.cpu().numpy()]  # the probe's own reference
    n, c, m = SMALL
    x_pad = torch.cat([x, x.new_zeros(1, c)])
    out: Dict[str, List[dict]] = {"small": [], "scale": []}
    for label, fn, plain in VARIANTS:
        got = fn(x, idx).cpu().numpy()
        err = float(np.abs(got - ref).max())
        print(f"[ok]   {label}: {got.ravel()[:4]}", flush=True)
        print(f"[{'correct' if err == 0.0 else 'WRONG'}] {label}: max abs error {err}", flush=True)
        row = {"label": label, "kernel": fn.__name__, "n": n, "c": c, "m": m,
               "dtype": "float32", "max_abs_err": err}
        if on_card:
            ops = 2.0 * m * n * c if fn is gather_onehot else 0.0
            b_ms, by = bound_ms(gather_bytes(n, c, m, 4), ops)
            row.update(ms=cuda_ms(lambda: fn(x, idx), iters),
                       plain_ms=cuda_ms(lambda: plain(x, idx), iters),
                       library_ms=cuda_ms(lambda: torch.index_select(x_pad, 0, idx), iters),
                       bound_ms=b_ms, bound_by=by)
            print(f"        {row['ms']:.5f} ms (plain {row['plain_ms']:.5f}, index_select "
                  f"{row['library_ms']:.5f}): launch-bound at this size", flush=True)
        out["small"].append(row)
    if not on_card:
        print("[scale] timing needs the card: not measured", flush=True)
        return out

    n, c, m = SCALE
    xb, ib = _inputs(SCALE, torch.bfloat16, (2, 3), dev)
    xb_pad = torch.cat([xb, xb.new_zeros(1, c)])
    nbytes = gather_bytes(n, c, m, 2)
    b_ms, by = bound_ms(nbytes)
    print(f"[scale] table [{n}, {c}] bfloat16 ({n * c * 2 / 1e6:.1f} MB), {m} indices; "
          f"bound {b_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s)",
          flush=True)
    ref_b = gather_ref(xb, ib)
    lib_ms = cuda_ms(lambda: torch.index_select(xb_pad, 0, ib), iters)
    plain_ms = cuda_ms(lambda: gather_ref(xb, ib), iters)
    for label, fn, _ in VARIANTS[:2]:
        got = fn(xb, ib)
        err = float((got.float() - ref_b.float()).abs().max().item())
        t = cuda_ms(lambda: fn(xb, ib), iters)
        row = {"label": label, "kernel": fn.__name__, "n": n, "c": c, "m": m,
               "dtype": "bfloat16", "max_abs_err": err, "ms": t, "ns_per_row": t * 1e6 / m,
               "gb_per_s": nbytes / (t * 1e6), "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": by}
        print(f"[scale] {label}: correct={err == 0.0} {t:.4f} ms, {row['ns_per_row']:.4f} ns/row, "
              f"{row['gb_per_s']:.1f} GB/s ({b_ms / t:.1%} of bound); plain {plain_ms:.4f} ms, "
              f"index_select {lib_ms:.4f} ms", flush=True)
        out["scale"].append(row)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, List[dict]]:
    p = argparse.ArgumentParser(description="row-gather probe (PyTorch port)")
    p.add_argument("--cpu", action="store_true", help="check the plain versions on the CPU")
    p.add_argument("--iters", type=int, default=20, help="timed calls per measurement")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}, torch {torch.__version__}", flush=True)
    return probe(dev, args.iters)


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(r["max_abs_err"] == 0.0 for rows in res.values() for r in rows) else 1)
