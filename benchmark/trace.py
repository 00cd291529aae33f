"""Readings of a torch.profiler Chrome trace: device events by bucket, the
union of device intervals inside a window, the longest idle gaps labelled by
the host operation running where each starts. A copy of the port's
parse_trace layout (`bucket`, the per-step breakdown, `idle`), kept here so
that the yardstick does not move with the program."""
from __future__ import annotations

import collections
import gzip
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation")
WINDOW = "benchmark_window"  # the record_function around the profiled steps
# kernels by their symbols in the port's csrc/*.cu
BUCKETS = (
    ("K1", re.compile(r"\bsparse_conv_(tc|tf32)_\w*kernel|\bsparse_conv_(fwd|wgrad|wgrad_reduce)"
                      r"_kernel\b")),
    ("K2", re.compile(r"\b(stats|apply|bwd_reduce|dx|vjp)_kernel\b")),
    ("conv", re.compile(r"cudnn|conv|xmma_(fprop|dgrad|wgrad)|fprop|dgrad|wgrad", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|cublas|nvjet|xmma", re.I)),
    ("copies", re.compile(r"copy|memcpy|memset|Memcpy|Memset", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def bucket(name: str, cat: str = "kernel") -> str:
    """The bucket of a device event by its category and kernel name."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copies"
    for label, pat in BUCKETS:
        if pat.search(name):
            return label
    return "other"


def load(trace) -> dict:
    """A Chrome trace as a dict: from a path (.json / .json.gz) or as given."""
    if isinstance(trace, dict):
        return trace
    opener = gzip.open if str(trace).endswith(".gz") else open
    with opener(trace, "rt") as f:
        return json.load(f)


def _x(tr: dict, cats) -> List[dict]:
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def window(tr: dict) -> Optional[Tuple[float, float]]:
    """(start, end) in trace microseconds of the benchmark's window
    annotation; None when the trace has none."""
    for e in _x(tr, ("user_annotation", "cpu_op", "python_function")):
        if e.get("name") == WINDOW:
            return float(e["ts"]), float(e["ts"] + e["dur"])
    return None


def device_events(tr: dict, span: Optional[Tuple[float, float]] = None) -> List[dict]:
    """The device events (kernels, copies, sets) that start inside `span`."""
    ev = _x(tr, DEVICE_CATS)
    if span is None:
        return ev
    return [e for e in ev if span[0] <= e["ts"] < span[1]]


def merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events: List[dict], span: Optional[Tuple[float, float]] = None) -> float:
    """Microseconds in which some device event ran (their union), clipped to `span`."""
    total = 0.0
    for s, e in merge((ev["ts"], ev["ts"] + ev["dur"]) for ev in events):
        if span is not None:
            s, e = max(s, span[0]), min(e, span[1])
        total += max(e - s, 0.0)
    return total


def by_name(events: List[dict]) -> Dict[str, Tuple[float, int]]:
    """Device microseconds and launches by kernel name."""
    out: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        g = out[e.get("name", "")]
        g[0] += e["dur"]
        g[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def idle_gaps(tr: dict, events: List[dict], span: Tuple[float, float],
              top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest stretches of `span` in which no device event ran,
    as (innermost host operation running where the gap starts, seconds)."""
    busy = [[max(s, span[0]), min(e, span[1])]
            for s, e in merge((ev["ts"], ev["ts"] + ev["dur"]) for ev in events)]
    edges = [span[0]] + [x for b in busy for x in b] + [span[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in _x(tr, HOST_CATS)
                  if e.get("name") != WINDOW)

    def label(t: float) -> str:
        inner = None
        for s, e, name in host:
            if s > t:
                break
            if e > t and (inner is None or s >= inner[0]):
                inner = (s, name)
        return "(none)" if inner is None else inner[1]

    return [(label(s), g / 1e6) for g, s in gaps]


def top_ops(events: List[dict], steps: int, top: int = 10) -> List[Tuple[str, float]]:
    """The `top` device operations by seconds a step, as (name, seconds)."""
    names = by_name(events)
    ranked = sorted(names.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name[:200], us / 1e6 / steps) for name, (us, _) in ranked]
