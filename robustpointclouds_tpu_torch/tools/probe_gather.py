"""Gather-rate probe: the four row-gather kernels, checked and timed on the card.

The counterpart of robustpointclouds_tpu/tools/probe_mosaic_gather.py. Each
gather formulation (kernels/gather.py: row vectors, elements, a row loop,
a one-hot product) is run at the probe's small shape ([512, 128] float32
table, 256 indices) and checked against numpy's x[idx]; then the row,
element and row-loop gathers are timed at the sparse conv's table size
([96000, 64] bfloat16, 864000 indices: 9 lookups a row). Each timed row
holds the time of back-to-back calls on the host's clock (CUDA events), the
kernel's own device time (torch.profiler, inputs cycled over copies that
exceed twice the L2 cache; only the kernel's records, exactly one a call),
the least time the card's memory and tensor cores allow for the bytes and
operations this data needs, the plain
PyTorch version and torch.index_select, and the host's cost of one call
split into the wrapper's pieces beside index_select's. Its ns per row and
GB/s are the gather rates the sparse-conv kernels' tiles are chosen from.

    python -m robustpointclouds_tpu_torch.tools.probe_gather [--cpu] [--iters N]

Runs on the card unless `--cpu`, which checks the plain versions at the
small shape and times nothing. Exits 1 if a kernel disagrees.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import gather as g
from ..kernels.gather import (gather_elems, gather_onehot, gather_onehot_ref, gather_ref,
                              gather_row_loop, gather_rows)

SMALL = (512, 128, 256)        # table rows, channels, indices (float32)
SCALE = (96000, 64, 96000 * 9)  # the same at the sparse conv's table size (bfloat16)
HBM_BYTES_PER_S = 3.35e12      # one H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"f32": 67e12, "tensor_f16": 989e12}  # CUDA cores; fp16/bf16 tensor cores
L2_BYTES = 50_000_000          # an H100's L2 cache

# (label, kernel, plain version); the first three are also timed at SCALE
VARIANTS = [("row gather (k_take, kg)", gather_rows, gather_ref),
            ("element gather (k_tal)", gather_elems, gather_ref),
            ("row loop (k_loop)", gather_row_loop, gather_ref),
            ("one-hot product (k_onehot)", gather_onehot, gather_onehot_ref)]
SCALE_KERNELS = 3
# the C entry point behind each wrapper
ENTRY = {"gather_rows": "rpc_gather_rows", "gather_elems": "rpc_gather_elems",
         "gather_row_loop": "rpc_gather_row_loop", "gather_onehot": "rpc_gather_onehot"}


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


def _profiled(fn, calls: int) -> list:
    """The CUDA records of one profile: `calls` calls of fn, run twice, the
    first round the profiler's warm-up cycle, only the second recorded; the
    profiler's own step annotation is not a kernel."""
    cycles = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: cycles.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [e for c in cycles for e in c if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def _named(key: str, name: str) -> bool:
    return re.search(rf"(?<!\w){name}(?!\w)", key) is not None


def device_ms(fn, iters: int, kernels: Optional[Dict[str, int]] = None,
              by_kernel: Optional[dict] = None) -> Optional[float]:
    """The device time per call of fn under torch.profiler: without the
    host's launch gaps that cuda_ms sees when a call's host work outlasts
    its kernels. kernels: {kernel name: its launches a call}; only those
    kernels' records count, and only a profile that holds exactly `iters`
    times each. None: the set of kernels one call records, profiled alone,
    must come back exactly `iters` times (a yardstick of eager ops). The
    profiler can drop or mix records in a process that has run many
    profiles; None (not measured, with what the profiles recorded printed)
    if three profiles in a row did not hold the set, never an average of
    what is left. by_kernel receives each counted kernel's ms a call."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        if kernels is None:
            want = {e.key: e.count * iters for e in _profiled(fn, 1)}
            events = mine = _profiled(fn, iters)
            got = {e.key: e.count for e in events}
        else:
            want = {k: c * iters for k, c in kernels.items()}
            events = _profiled(fn, iters)
            mine = [e for e in events if any(_named(e.key, k) for k in kernels)]
            got = {k: sum(e.count for e in mine if _named(e.key, k)) for k in kernels}
        if want and got == want:
            if by_kernel is not None:
                for e in mine:
                    name = re.search(r"(\w+_kernel)\b", e.key)
                    key = name.group(1) if name else e.key[:40]
                    ms = e.self_device_time_total / 1e3 / iters
                    by_kernel[key] = by_kernel.get(key, 0.0) + ms
            return sum(e.self_device_time_total for e in mine) / 1e3 / iters
        seen.append({e.key[:48]: e.count for e in events})
    print(f"        device time not measured: {iters} calls a profile, wanted "
          f"{kernels or 'the set of one call'} each time, recorded {seen}", flush=True)
    return None


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of `fn`, taken before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / iters


def gather_bytes(rows: int, c: int, m: int, itemsize: int) -> int:
    """Bytes a gather must move: the output written once, the indices read
    once, and `rows` rows of the table (rows_read) read once."""
    return m * c * itemsize + m * 4 + rows * c * itemsize


def rows_read(kernel: str, idx: torch.Tensor, n: int) -> int:
    """Table rows a gather form must read for this idx: the dense one-hot
    product all N; a copy only the distinct rows idx hits in [0, N)."""
    if kernel == "gather_onehot":
        return n
    return int(torch.unique(idx[(idx >= 0) & (idx < n)]).numel())


def gather_ops(kernel: str, n: int, c: int, m: int, itemsize: int) -> float:
    """Operations of a gather form on the tensor cores: the one-hot product
    does 2*M*N*C per 10-bit plane of x's words (4 for float32, 2 for
    bfloat16); the copies do none."""
    if kernel != "gather_onehot":
        return 0.0
    return g._OH_PLANES[itemsize] * 2.0 * m * n * c


def bound_ms(nbytes: float, ops: float = 0.0, peak: str = "tensor_f16"):
    """(the least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _inputs(shape, dtype, seeds, dev):
    n, c, m = shape
    x = torch.from_numpy(np.random.RandomState(seeds[0]).randn(n, c).astype(np.float32))
    idx = np.random.RandomState(seeds[1]).randint(0, n, m).astype(np.int32)
    return x.to(dtype).to(dev), torch.from_numpy(idx).to(dev)


def _cold(x, idx):
    """A call of fn on copies of (x, idx) in turn, enough to exceed the L2
    cache twice, so that each call reads its inputs from device memory."""
    nbytes = x.numel() * x.element_size() + idx.numel() * 4
    sets = [(x, idx)] + [(x.clone(), idx.clone())
                         for _ in range(max(1, min(512, -(-2 * L2_BYTES // nbytes))) - 1)]

    def call(fn):
        state = {"i": 0}

        def run():
            a = sets[state["i"] % len(sets)]
            state["i"] += 1
            return fn(*a)
        return run
    return call


def host_split(fn: Callable, x: torch.Tensor, idx: torch.Tensor, x_pad: torch.Tensor) -> dict:
    """Host microseconds of one call of a wrapper, split into its pieces (the
    checks, the launch plan, the output's allocation, the stream lookup, the
    ctypes call that enqueues the kernel), beside the whole call and
    torch.index_select's."""
    name = fn.__name__
    m, c, eb = idx.shape[0], x.shape[1], x.element_size()
    align = g._align(x)
    plan, extra = None, ()
    plan_fns = {"gather_row_loop": g.row_loop_plan, "gather_onehot": g.onehot_plan,
                "gather_elems": g.elem_plan}
    if name in plan_fns:
        plan = lambda: g._plan_args(plan_fns[name], m, c, eb, align)  # noqa: E731
        extra = (plan(),)
    else:  # gather_rows
        extra = (c * eb // 16,)
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    cfn = g._fn(ENTRY[name])
    dev = x.get_device()
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, x.shape[0], *extra, g._stream(dev))
    return {"check_us": host_us(lambda: g._check(name, x, idx)),
            "plan_us": host_us(plan) if plan else 0.0,
            "alloc_us": host_us(lambda: x.new_empty((m, c))),
            "stream_us": host_us(lambda: g._stream(x.get_device())),
            "ctypes_launch_us": host_us(lambda: cfn(*args)),
            "call_us": host_us(lambda: fn(x, idx)),
            "index_select_us": host_us(lambda: torch.index_select(x_pad, 0, idx))}


def _fmt(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def _time_row(row, fn, plain, x, idx, x_pad, iters):
    """Fill a probe row's times on the card: ms, device_ms (inputs cycled past
    the L2), plain_ms, library_ms, the bound of the bytes and operations this
    idx needs, and the host split."""
    n, c = x.shape
    m = idx.shape[0]
    eb = x.element_size()
    row["ms"] = cuda_ms(lambda: fn(x, idx), iters)
    row["device_ms"] = device_ms(_cold(x, idx)(fn), iters, {f"{fn.__name__}_kernel": 1})
    nbytes = gather_bytes(rows_read(fn.__name__, idx, n), c, m, eb)
    b_ms, by = bound_ms(nbytes, gather_ops(fn.__name__, n, c, m, eb))
    row.update(plain_ms=cuda_ms(lambda: plain(x, idx), iters),
               library_ms=cuda_ms(lambda: torch.index_select(x_pad, 0, idx), iters),
               bound_ms=b_ms, bound_by=by, bytes=nbytes, host=host_split(fn, x, idx, x_pad))
    h = row["host"]
    print(f"        {row['ms']:.5f} ms on the host's clock (device {_fmt(row['device_ms'])}, bound "
          f"{b_ms:.6f} by {by}; plain {row['plain_ms']:.5f}, index_select "
          f"{row['library_ms']:.5f}); host us per call {h['call_us']:.2f} (check "
          f"{h['check_us']:.2f}, plan {h['plan_us']:.2f}, alloc {h['alloc_us']:.2f}, stream "
          f"{h['stream_us']:.2f}, ctypes launch {h['ctypes_launch_us']:.2f}) vs index_select "
          f"{h['index_select_us']:.2f}", flush=True)


def probe(dev: torch.device, iters: int = 20) -> Dict[str, List[dict]]:
    """Check every variant at SMALL and, on the card, time them there and
    the row, element and row-loop gathers at SCALE. Returns {"small": rows,
    "scale": rows}; each row holds the variant's label, kernel name and
    max_abs_err, and on the card the times of `_time_row`."""
    on_card = dev.type == "cuda"
    x, idx = _inputs(SMALL, torch.float32, (0, 1), dev)
    ref = x.cpu().numpy()[idx.cpu().numpy()]  # the probe's own reference
    n, c, m = SMALL
    x_pad = torch.cat([x, x.new_zeros(1, c)])
    out: Dict[str, List[dict]] = {"small": [], "scale": []}
    for label, fn, plain in VARIANTS:
        got = fn(x, idx).cpu().numpy()
        err = float(np.abs(got - ref).max())
        name = fn.__name__
        print(f"[ok]   {label}: {got.ravel()[:4]}", flush=True)
        print(f"[{'correct' if err == 0.0 else 'WRONG'}] {label}: max abs error {err}", flush=True)
        row = {"label": label, "kernel": name, "n": n, "c": c, "m": m,
               "dtype": "float32", "max_abs_err": err}
        if on_card:
            _time_row(row, fn, plain, x, idx, x_pad, iters)
        out["small"].append(row)
    if not on_card:
        print("[scale] timing needs the card: not measured", flush=True)
        return out

    n, c, m = SCALE
    xb, ib = _inputs(SCALE, torch.bfloat16, (2, 3), dev)
    xb_pad = torch.cat([xb, xb.new_zeros(1, c)])
    rows = rows_read("gather_rows", ib, n)
    nbytes = gather_bytes(rows, c, m, 2)
    print(f"[scale] table [{n}, {c}] bfloat16 ({n * c * 2 / 1e6:.1f} MB), {m} indices hitting "
          f"{rows} rows; the copies' bound {bound_ms(nbytes)[0]:.6f} ms ({nbytes / 1e6:.1f} MB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)
    ref_b = gather_ref(xb, ib)
    for label, fn, plain in VARIANTS[:SCALE_KERNELS]:
        name = fn.__name__
        got = fn(xb, ib)
        err = float((got.float() - ref_b.float()).abs().max().item())
        row = {"label": label, "kernel": name, "n": n, "c": c, "m": m,
               "dtype": "bfloat16", "max_abs_err": err}
        print(f"[scale] {label}: correct={err == 0.0}", flush=True)
        _time_row(row, fn, plain, xb, ib, xb_pad, iters)
        row.update(ns_per_row=row["ms"] * 1e6 / m, gb_per_s=row["bytes"] / (row["ms"] * 1e6))
        print(f"[scale] {label}: {row['ns_per_row']:.4f} ns/row, {row['gb_per_s']:.1f} GB/s "
              f"({row['bound_ms'] / row['ms']:.1%} of bound)", flush=True)
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
