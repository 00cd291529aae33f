"""Readings of one named span of the program in a torch.profiler Chrome
trace, nested spans included: its wall time a step and the device
operations launched inside it. For spans that the stage table
(`spans.py`) does not name, so that its stages and the root's own time
stay as they were; a trace without the span (a program that has none)
reads None."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .trace import merge


def intervals(tr: dict, name: str, window: Tuple[float, float]) -> List[List[float]]:
    """The merged [start, end) trace us of the spans called `name` that
    start inside `window`."""
    return merge((float(e["ts"]), float(e["ts"] + e["dur"])) for e in tr.get("traceEvents", [])
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name") == name and window[0] <= e["ts"] < window[1])


def span_ms(ctx, name: str) -> Optional[float]:
    """The span's wall ms a step on the trace's host clock."""
    if ctx.span is None:
        return None
    iv = intervals(ctx.trace, name, ctx.span)
    return sum(e - s for s, e in iv) / 1e3 / ctx.steps if iv else None


def span_ops(ctx, name: str) -> Optional[float]:
    """The device operations a step whose launch (the CUDA API call of the
    operation's correlation id, any host thread) lies inside the span."""
    if ctx.span is None:
        return None
    iv = intervals(ctx.trace, name, ctx.span)
    if not iv:
        return None
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in ctx.trace.get("traceEvents", [])
                if e.get("ph") == "X" and str(e.get("cat", "")).startswith("cuda_")
                and e.get("args", {}).get("correlation") is not None}
    starts = [s for s, _ in iv]
    n = 0
    for ev in ctx.events:
        t = launches.get(ev.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t < iv[i][1]
    return n / ctx.steps
