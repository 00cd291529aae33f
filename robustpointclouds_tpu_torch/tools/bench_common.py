"""What the port's measurement tools share: the device, the timer, the
profiler window, the card record, the launch counters and the JSON lines.

The JAX package's tools (robustpointclouds_tpu/tools/bench_*.py,
microbench.py, profile_components.py, diag_plan_*.py) each carried their
own `timed` helper around `lax.scan` / `fori_loop` with a carried epsilon.
On the card the method is (bench_step, bench_inference,
profile_components, microbench):
  * the host clock around work that ends in `torch.cuda.synchronize()`,
    with CUDA events beside it;
  * the median over at least 5 repeats after a warm-up, with the min, max
    and count of the repeats (`spread`);
  * inputs perturbed per step by an epsilon that depends on the carry
    (`1e-6 * loss.detach()` on the device, no host sync): steps cannot
    overlap or hoist, JAX's rule;
  * several distinct inputs cycled, and L2-cold copies for kernel times
    (`l2_cold`), microbench's rule;
  * variants compared in turns, A B B A, inside one process (`in_turns`):
    the host's speed varies 20-40% between processes.
The device busy time comes from torch.profiler in a window of its own, apart
from the timed one (`profile_window`).

Every tool runs on the card unless `--cpu` (or BENCH_CPU=1) asks for the
CPU, and raises without a card; `--tiny` (BENCH_TINY=1) takes the CPU test
sizes. A CPU run times PyTorch's CPU kernels: its records say
`"device": "cpu"` and carry no device metric (`device_busy_ms` None).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..core.spans import device_entries

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates without
# sparsity, at the card's 700 W limit): the one definition that every bound
# and mfu of the port reads (chip_smoke.py, tools/probe_gather, these tools)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16_tensor": 989e12, "tf32_tensor": 495e12, "f32": 67e12}
PEAK_BF16_FLOPS = PEAK_OPS["bf16_tensor"]
L2_BYTES = 50_000_000  # an H100's L2 cache
MIN_REPEATS = 5
EPOCH = 5  # the train step's epoch in every tool: the adversary's gate open, as JAX's benches


def env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default) == "1"


def add_device_args(parser: argparse.ArgumentParser, repeats: int = MIN_REPEATS,
                    warmup: int = 2) -> None:
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (BENCH_CPU=1); without it the tool needs a card")
    parser.add_argument("--tiny", action="store_true",
                        help="the CPU test sizes (BENCH_TINY=1)")
    parser.add_argument("--repeats", type=int, default=repeats,
                        help=f"timed repeats, at least {MIN_REPEATS} on the card")
    parser.add_argument("--warmup", type=int, default=warmup)
    parser.add_argument("--seed", type=int, default=0)


def device_of(args: argparse.Namespace) -> torch.device:
    """The CPU when --cpu / BENCH_CPU=1, else the card (raises without one)."""
    if args.cpu or env_flag("BENCH_CPU"):
        return torch.device("cpu")
    return resolve_device(None)


def is_tiny(args: argparse.Namespace) -> bool:
    return bool(args.tiny) or env_flag("BENCH_TINY")


def check_repeats(dev: torch.device, repeats: int) -> None:
    if dev.type == "cuda" and repeats < MIN_REPEATS:
        raise ValueError(f"--repeats {repeats}: a card measurement takes the median of at "
                         f"least {MIN_REPEATS}")


def card_record(dev: torch.device) -> Dict[str, Any]:
    """The device a record ran on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (or "cpu"), the host's cores and torch's intra-op threads."""
    rec: Dict[str, Any] = {"device": dev.type, "cpu_count": os.cpu_count(),
                           "torch_threads": torch.get_num_threads()}
    if dev.type == "cuda":
        line = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
        name, _, limit = line.rpartition(",")
        rec.update(name=name.strip(), power_limit=limit.strip(), nvidia_smi=line)
    else:
        rec.update(name="cpu", power_limit=None)
    return rec


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spread(ms: Sequence[float]) -> Dict[str, Any]:
    return {"min": min(ms), "max": max(ms), "n": len(ms)}


def median(ms: Sequence[float]) -> float:
    return statistics.median(ms)


class Timed:
    """Host-clock ms (and on the card CUDA-event ms) of each call of a step
    function, every call ending in a synchronise."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.host_ms: List[float] = []
        self.event_ms: List[float] = []

    def __call__(self, fn: Callable[[], Any]) -> Any:
        dev = self.dev
        sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            end.record()
        sync(dev)
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        if dev.type == "cuda":
            self.event_ms.append(start.elapsed_time(end))
        return out

    def summary(self, key: str = "step_ms") -> Dict[str, Any]:
        """{key: median host ms, key_spread, key_events: median CUDA-event ms}."""
        out = {key: median(self.host_ms), f"{key}_spread": spread(self.host_ms)}
        out[f"{key}_events"] = median(self.event_ms) if self.event_ms else None
        return out


def in_turns(fns: Dict[str, Callable[[], Any]], dev: torch.device, repeats: int,
             warmup: int = 1) -> Dict[str, Timed]:
    """The callables timed in turns, A B B A ..., `repeats` calls each after
    `warmup` untimed ones each, in one process."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    timers = {k: Timed(dev) for k in fns}
    order = list(fns)
    i = 0
    while min(len(t.host_ms) for t in timers.values()) < repeats:
        for k in (order if i % 2 == 0 else order[::-1]):
            if len(timers[k].host_ms) < repeats:
                timers[k](fns[k])
        i += 1
    return timers


def kernel_ms(fn: Callable[..., Any], sets: Sequence[tuple], dev: torch.device,
              iters: int = 20, warmup: int = 3) -> float:
    """ms a call of fn, cycling the argument sets (l2_cold copies): CUDA
    events over `iters` back-to-back calls on the card, the host clock
    around them (ending in nothing to wait for) on the CPU."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    return (time.perf_counter() - t0) * 1e3 / iters


def l2_cold(tensors: Sequence[torch.Tensor], dev: torch.device) -> List[tuple]:
    """Copies of `tensors` to take in turn, enough to exceed the card's L2
    twice, so that back-to-back calls read their inputs from device memory
    (chip_smoke.py's rule); one set on the CPU."""
    if dev.type != "cuda":
        return [tuple(tensors)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    k = max(1, min(16, -(-2 * L2_BYTES // max(nbytes, 1))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(k - 1)]


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launches() -> Dict[str, int]:
    """The K1 / K2 launch counters (kernels/sparse_conv.py's `.launches` /
    `.tf32_launches` per wrapper, kernels/masked_stats.py's wrappers and
    `KERNEL_LAUNCHES`), as chip_smoke.py reads them. They count kernel
    launches on the card only: a CPU tensor takes the plain versions."""
    from ..kernels import masked_stats as ms
    from ..kernels import sparse_conv as sc

    out = {f"k1_{k}": getattr(sc, f"sparse_conv{s}").launches
           for k, s in (("fwd", ""), ("dgrad", "_dgrad"), ("wgrad", "_wgrad"))}
    out["k1_tf32"] = sum(getattr(sc, f"sparse_conv{s}").tf32_launches
                         for s in ("", "_dgrad", "_wgrad"))
    out.update(k2_stats=ms.masked_stats.launches, k2_stats_bwd=ms.masked_stats_bwd.launches,
               k2_bn=ms.masked_batch_norm.launches, k2_bn_bwd=ms.masked_batch_norm_bwd.launches,
               k2_kernels=sum(ms.KERNEL_LAUNCHES.values()))
    return out


def launch_delta(before: Dict[str, int], after: Dict[str, int], per: int = 1) -> Dict[str, float]:
    return {k: (after[k] - before[k]) / per for k in after}


def require_launches(delta: Dict[str, float], keys: Sequence[str], where: str,
                     dev: torch.device) -> None:
    """On the card, raise unless each counter of `keys` grew in the window:
    the kernels ran there and not their plain versions."""
    if dev.type != "cuda":
        return
    missing = [k for k in keys if not delta.get(k)]
    if missing:
        raise RuntimeError(f"{where}: no launch of {missing} in the timed window: {delta}")


def profile_window(fn: Callable[[], Any], dev: torch.device, calls: int,
                   trace_path: Optional[str] = None) -> Dict[str, Any]:
    """`calls` calls of fn under torch.profiler, in a window of their own:
    the device busy ms a call (kernels, copies and memsets summed, CUPTI's
    times), device operations a call, and the window's host ms a call; the
    Chrome trace written to `trace_path` when given. On the CPU the device
    keys are None."""
    sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        sync(dev)
    window_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    out = {"profiled_ms": window_ms / calls, "device_busy_ms": None, "device_ops": None}
    if dev.type == "cuda":
        ev = device_entries(prof.key_averages())
        n = sum(e.count for e in ev)
        if n:
            out["device_busy_ms"] = sum(e.self_device_time_total for e in ev) / 1e3 / calls
            out["device_ops"] = n / calls
    if trace_path:
        out["trace"] = trace_path
    return out


def idle_share(busy_ms: Optional[float], wall_ms: float) -> Optional[float]:
    """1 - device busy / wall, both a step; None where busy was not measured."""
    return None if busy_ms is None else 1.0 - busy_ms / wall_ms


class PeakMemory:
    """Peak device memory (GiB) of what runs inside the `with`; None on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.gib: Optional[float] = None

    def __enter__(self):
        if self.dev.type == "cuda":
            sync(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            sync(self.dev)
            self.gib = torch.cuda.max_memory_allocated(self.dev) / 2 ** 30
        return False


def emit(record: Dict[str, Any], out: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Print the record as one JSON line; append it to `out` when given."""
    print(json.dumps(record), flush=True)
    if out is not None:
        out.append(record)
    return record


def trace_path(name: str) -> str:
    """Where a tool writes a requested trace: chiprun_out/traces/ under the
    working directory (git ignores it)."""
    return os.path.join("chiprun_out", "traces", f"{name}.json.gz")
