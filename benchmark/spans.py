"""Readings of the program's stage spans in a torch.profiler Chrome trace:
each span's self time, and each device operation put down to the stage
whose self time holds its launch. A copy of the port's parse_trace stage
table (`stages`), with its own copy of the span names, kept here so that the
yardstick does not move with the program; it imports nothing of the port.

The program marks its stages with `record_function` spans (the port's
core/spans.py) while a profiler records: a root span around the train step
or the serve, and one span a stage inside it. A trace without them (a
program that has none) reads None."""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Optional

from .trace import device_events, merge

SPANS = ("rpc.train_step", "rpc.serve", "rpc.plan", "rpc.adversary", "rpc.encoder",
         "rpc.dense", "rpc.loss", "rpc.backward", "rpc.optimizer", "rpc.decode")
# each kind's root span and the stages inside it (span names less "rpc.")
ROOTS = {"train": "train_step", "eval": "serve"}
STAGES = {"train": ("plan", "adversary", "encoder", "dense", "loss", "backward", "optimizer"),
          "eval": ("plan", "adversary", "encoder", "dense", "decode")}

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _cut(s, e, cuts):
    """[s, e) less the merged, sorted intervals `cuts`."""
    out, cur = [], s
    for a, b in cuts:
        if a > cur:
            out.append((cur, min(a, e)))
        cur = max(cur, b)
    if cur < e:
        out.append((cur, e))
    return out


def _overlap(segments, busy):
    """Microseconds of `segments` that the merged, sorted `busy` covers."""
    starts = [b[0] for b in busy]
    total = 0.0
    for s, e in segments:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            total += max(min(e, busy[i][1]) - max(s, busy[i][0]), 0.0)
            i += 1
    return total


def stage_table(tr, window=None):
    """By stage (a span's name less "rpc."): the spans' count, their self
    us (each span's interval less those of the spans nested in it on its
    thread), the device operations whose launch lies in that self time (the
    launch found by the operation's correlation id; the innermost span on
    any host thread, so the autograd thread's launches go to the main
    thread's backward), the union of those operations' device us, the us
    of the self time in which no device operation ran, and the host syncs
    in the self time. Under None: the operations whose launch lies in no
    span or is not in the trace. Spans and operations inside `window`
    (trace us) when given."""
    def inside(t):
        return window is None or window[0] <= t < window[1]

    threads = collections.defaultdict(list)
    for e in tr.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in SPANS and inside(e["ts"])):
            threads[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"] + e["dur"]), e["name"][4:]))
    nodes = []
    for spans in threads.values():
        stack = []
        for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and nodes[stack[-1]][1] <= s:
                stack.pop()
            if stack:
                nodes[stack[-1]][3].append((s, e))
            stack.append(len(nodes))
            nodes.append((s, e, name, []))

    def blank():
        return {"spans": 0, "self_us": 0.0, "ops": 0, "device_us": 0.0, "idle_us": 0.0,
                "syncs": 0}

    table = {None: blank()}
    segs = []
    for s, e, name, children in nodes:
        row = table.setdefault(name, blank())
        row["spans"] += 1
        for a, b in _cut(s, e, merge(children)):
            row["self_us"] += b - a
            segs.append((a, b, s, name))
    segs.sort()
    seg_starts = [g[0] for g in segs]
    reach, last = [], float("-inf")
    for g in segs:
        last = max(last, g[1])
        reach.append(last)

    def stage_at(t):
        best = None
        i = bisect.bisect_right(seg_starts, t) - 1
        while i >= 0 and reach[i] > t:
            if segs[i][1] > t and (best is None or segs[i][2] > best[2]):
                best = segs[i]
            i -= 1
        return None if best is None else best[3]

    launches, syncs = {}, []
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or not str(e.get("cat", "")).startswith("cuda_"):
            continue  # not a call of the CUDA API
        c = e.get("args", {}).get("correlation")
        if c is not None:
            launches[c] = float(e["ts"])
        if e.get("name") in SYNC_CALLS:
            syncs.append(float(e["ts"]))
    devs = device_events(tr, window)
    mine = collections.defaultdict(list)
    for e in devs:
        t = launches.get(e.get("args", {}).get("correlation"))
        stage = None if t is None else stage_at(t)
        table[stage]["ops"] += 1
        mine[stage].append((e["ts"], e["ts"] + e["dur"]))
    for stage, ivs in mine.items():
        table[stage]["device_us"] = sum(b - a for a, b in merge(ivs))
    for t in syncs:
        if inside(t):
            table[stage_at(t)]["syncs"] += 1
    busy = merge((e["ts"], e["ts"] + e["dur"]) for e in devs)
    for stage, row in table.items():
        if stage is not None:
            own = [(a, b) for a, b, _, name in segs if name == stage]
            row["idle_us"] = row["self_us"] - _overlap(own, busy)
    return table


def table(ctx) -> Dict:
    """The stage table of the traced steps' window, made once a run."""
    got = getattr(ctx, "stage_table", None)
    if got is None:
        got = ctx.stage_table = stage_table(ctx.trace, ctx.span)
    return got


def _row(ctx, stage: str) -> Optional[Dict]:
    """The stage's row, where the cell's kind has the stage and the trace
    holds its root and the stage's span; else None."""
    if ctx.span is None or stage not in STAGES[ctx.kind]:
        return None
    t = table(ctx)
    if ROOTS[ctx.kind] not in t or stage not in t:
        return None
    return t[stage]


def stage_ms(ctx, stage: str) -> Optional[float]:
    """The stage's self wall time a step, ms on the trace's host clock."""
    row = _row(ctx, stage)
    return None if row is None else row["self_us"] / 1e3 / ctx.steps


def stage_ops(ctx, stage: str) -> Optional[float]:
    """The device operations (kernels, copies, sets) a step launched while
    the host was in the stage's self time."""
    row = _row(ctx, stage)
    return None if row is None else row["ops"] / ctx.steps


def host_syncs(ctx) -> Optional[float]:
    """cudaStreamSynchronize, cudaDeviceSynchronize and cudaEventSynchronize
    calls a step inside the root span (every stage span lies inside it)."""
    if ctx.span is None:
        return None
    t = table(ctx)
    if ROOTS[ctx.kind] not in t:
        return None
    return sum(r["syncs"] for k, r in t.items() if k is not None) / ctx.steps
