"""Headless summaries of a profiler trace (counterpart of robustpointclouds_tpu/tools/parse_xplane.py).

Two layouts:
  * JAX's (a jax.profiler trace directory, `plugins/profile/<run>/
    *.trace.json.gz`): `summarize`, `device_module_ms`, `_device_op_events`
    and `breakdown` on a directory are JAX's functions, copied, giving its
    numbers (tests/test_torch_parse_trace.py holds them to JAX's on the
    same traces);
  * torch.profiler's Chrome trace (`export_chrome_trace`, `.json` or
    `.json.gz`), the port's: `device_ms(trace, name_substr)` sums the
    device's kernel / memcpy / memset events (None when the trace holds
    none: a CPU-only run, as device_module_ms on a CPU trace);
    `breakdown(trace, steps)` gives ms and launches a step by kernel name
    and by bucket (K1 / K2 / K3 by their symbols in the port's csrc/*.cu,
    cuDNN convolutions, GEMMs, elementwise, copies, other); `idle(trace,
    top)` the idle share of the device window and its longest idle gaps,
    each labelled by the innermost host operation running where it starts;
    `stages(trace, steps)` the port's stage spans (core/spans.py) a step:
    each span's self ms, the device operations launched in it, their
    device ms, the device's idle ms while the host was in it, and the host
    syncs it made.

Usage: python -m robustpointclouds_tpu_torch.tools.parse_trace TRACE [topk]
       python -m robustpointclouds_tpu_torch.tools.parse_trace breakdown TRACE [steps]
       python -m robustpointclouds_tpu_torch.tools.parse_trace idle TRACE [top]
       python -m robustpointclouds_tpu_torch.tools.parse_trace stages TRACE [steps]
"""
from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
import re
import sys


def summarize(trace_dir, topk=30):
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.trace.json.gz"))
    if not paths:
        raise SystemExit(f"no trace.json.gz under {trace_dir}")
    for p in sorted(paths):
        with gzip.open(p) as f:
            tr = json.load(f)
        events = tr.get("traceEvents", [])
        # pid -> human name from metadata events
        pid_names = {}
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                pid_names[e.get("pid")] = e.get("args", {}).get("name", "")
        by_pid = collections.defaultdict(
            lambda: (collections.Counter(), collections.Counter()))
        for e in events:
            if e.get("ph") == "X" and "dur" in e:
                tot, cnt = by_pid[e.get("pid")]
                tot[e["name"]] += e["dur"]
                cnt[e["name"]] += 1
        print(f"\n==== {p}")
        for pid, (tot, cnt) in sorted(by_pid.items()):
            label = pid_names.get(pid, "")
            span = sum(tot.values())
            print(f"\n-- pid {pid} '{label}' (sum of event durations "
                  f"{span / 1e6:.3f} s)")
            for name, us in tot.most_common(topk):
                print(f"  {us / 1e6:9.3f} s  x{cnt[name]:<7d} {name[:120]}")


def _latest_trace_paths(trace_dir):
    """Trace files of the MOST RECENT capture only. jax.profiler.trace
    appends a new timestamped subdir per run; summing across subdirs
    double-counts re-used trace dirs (a 391 ms pillar "step" was once an
    older capture's 230 ms and the real 162 summed)."""
    runs = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*")))
    if not runs:
        return []
    return sorted(glob.glob(os.path.join(runs[-1], "*.trace.json.gz")))


def device_module_ms(trace_dir, name_substr="scan_steps"):
    """Total duration (ms) of the named XLA module's executions on the
    DEVICE plane — the wall-clock-independent step time. Sums module-level
    events only (op events nest inside modules; summing everything would
    double count), on pids whose process_name mentions the device, in the
    LATEST capture under the dir. Returns None if the trace holds no
    matching device event, e.g. on CPU-only runs (the CPU backend has no
    separate device plane)."""
    paths = _latest_trace_paths(trace_dir)
    total_us = 0.0
    found = False
    for p in sorted(paths):
        with gzip.open(p) as f:
            tr = json.load(f)
        events = tr.get("traceEvents", [])
        pid_names = {}
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                pid_names[e.get("pid")] = e.get("args", {}).get("name", "")
        device_pids = {
            pid for pid, nm in pid_names.items()
            if any(s in nm for s in ("TPU", "Device", "/device:", "XLA Modules"))
        }
        tid_names = {}
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                tid_names[(e.get("pid"), e.get("tid"))] = (
                    e.get("args", {}).get("name", ""))
        matches = [
            e for e in events
            if (e.get("ph") == "X" and "dur" in e
                and e.get("pid") in device_pids
                and name_substr in e.get("name", ""))
        ]
        # prefer the module-level line when present (op/step lines can carry
        # events with the same module name — counting both double-counts)
        mod = [e for e in matches if "XLA Modules"
               in tid_names.get((e.get("pid"), e.get("tid")), "")]
        for e in (mod or matches):
            total_us += e["dur"]
            found = True
    return total_us / 1e3 if found else None


def _device_op_events(trace_dir):
    """Yield device-plane XLA op events (the 'XLA Ops' line) with their args.

    These carry full HLO provenance: `hlo_category`, `long_name` (HLO with
    operand shapes/layouts), `source` (python file:line), `model_flops`,
    `raw_bytes_accessed` — everything needed to attribute a step to source
    code without TensorBoard (VERDICT r4 item 2). Latest capture only."""
    paths = _latest_trace_paths(trace_dir)
    for p in sorted(paths):
        with gzip.open(p) as f:
            tr = json.load(f)
        events = tr.get("traceEvents", [])
        pid_names = {}
        tid_names = {}
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                pid_names[e.get("pid")] = e.get("args", {}).get("name", "")
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                tid_names[(e.get("pid"), e.get("tid"))] = (
                    e.get("args", {}).get("name", ""))
        device_pids = {pid for pid, nm in pid_names.items()
                       if "TPU" in nm or "/device:" in nm}
        op_tids = {k for k, v in tid_names.items()
                   if v == "XLA Ops" and k[0] in device_pids}
        for e in events:
            if e.get("ph") == "X" and "dur" in e and (
                    e.get("pid"), e.get("tid")) in op_tids:
                yield e


# Coarse attribution buckets (VERDICT r4 item 2): categories the roofline
# discussion uses. An op is bucketed by its HLO category first (gathers are
# 'custom fusion'; retiling copies/reshapes are 'data formatting'), with its
# python source kept for the detail rows.
_SKIP_CATS = {"while", "async-start", "async-done", "copy-start",
              "copy-done", "custom-call"}


def _xla_breakdown(trace_dir, steps=10, topk=25):
    """Per-step device-time table grouped by (source file:line, category).

    `steps`: executions of the timed module in the trace (bench_r4_step and
    bench_one_variant run a 10-iteration scan). Prints the grouped table the
    round-5 optimization work keys off; see PARITY.md round-5 section."""
    import collections as _c
    by_src = _c.defaultdict(lambda: [0.0, 0, 0.0, 0.0])
    by_cat = _c.defaultdict(float)
    tot = 0.0
    for e in _device_op_events(trace_dir):
        a = e.get("args", {})
        cat = a.get("hlo_category", "?")
        if cat in _SKIP_CATS:
            continue
        src = a.get("source", "")
        src = "/".join(src.split("/")[-2:]) if src else f"<no-src:{cat}>"
        g = by_src[(src, cat)]
        g[0] += e["dur"]
        g[1] += 1
        g[2] += float(a.get("model_flops", 0) or 0)
        g[3] += float(a.get("raw_bytes_accessed", 0) or 0)
        by_cat[cat] += e["dur"]
        tot += e["dur"]
    print(f"device op time: {tot / 1e3 / steps:.1f} ms/step "
          f"({steps} steps assumed)\n")
    print("by HLO category:")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / steps:8.2f} ms/step  {cat}")
    print(f"\ntop {topk} (source, category):")
    rows = sorted(by_src.items(), key=lambda kv: -kv[1][0])
    for (src, cat), (us, n, fl, b) in rows[:topk]:
        print(f"  {us / 1e3 / steps:8.2f} ms/step x{n / steps:7.1f} "
              f"{b / 1e6 / steps:8.0f} MB {fl / 1e9 / steps:8.1f} GF  "
              f"{cat:<22} {src}")



# ---- torch.profiler's Chrome trace (the port's layout)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "python_function", "user_annotation")
# the port's kernels by their symbols in robustpointclouds_tpu_torch/csrc/*.cu
_BUCKETS = (
    ("K1", re.compile(r"\bsparse_conv_(tc|tf32)_\w*kernel|\bsparse_conv_(fwd|wgrad|wgrad_reduce)"
                      r"_kernel\b")),
    ("K2", re.compile(r"\b(stats|apply|bwd_reduce|dx|vjp)_kernel\b")),
    ("K3", re.compile(r"\bgather_(rows|elems|row_loop|onehot)_kernel\b")),
    ("conv", re.compile(r"cudnn|conv|xmma_(fprop|dgrad|wgrad)|fprop|dgrad|wgrad", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|cublas|nvjet|xmma", re.I)),
    ("copies", re.compile(r"copy|memcpy|memset|Memcpy|Memset", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def bucket(name: str, cat: str = "kernel") -> str:
    """The bucket of a device event by its category and kernel name."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copies"
    for label, pat in _BUCKETS:
        if pat.search(name):
            return label
    return "other"


def load_trace(trace) -> dict:
    """A Chrome trace as a dict: from a path (.json / .json.gz) or as given."""
    if isinstance(trace, dict):
        return trace
    opener = gzip.open if str(trace).endswith(".gz") else open
    with opener(trace, "rt") as f:
        return json.load(f)


def _device_events(tr):
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in _DEVICE_CATS]


def device_ms(trace, name_substr: str = ""):
    """Summed duration (ms) of the device events whose name holds
    `name_substr`; None when the trace holds no device event."""
    events = _device_events(load_trace(trace))
    if not events:
        return None
    return sum(e["dur"] for e in events if name_substr in e.get("name", "")) / 1e3


def _torch_breakdown(trace, steps: int = 1, topk: int = 25) -> dict:
    """Device ms and launches a step by bucket and by kernel name."""
    events = _device_events(load_trace(trace))
    by_name = collections.defaultdict(lambda: [0.0, 0, ""])
    by_bucket = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        b = bucket(e.get("name", ""), e.get("cat"))
        g = by_name[e.get("name", "")]
        g[0] += e["dur"]
        g[1] += 1
        g[2] = b
        by_bucket[b][0] += e["dur"]
        by_bucket[b][1] += 1
    total = sum(v[0] for v in by_bucket.values())
    out = {
        "steps": steps,
        "device_ms": total / 1e3 / steps if events else None,
        "buckets": {b: {"ms": us / 1e3 / steps, "launches": n / steps}
                    for b, (us, n) in sorted(by_bucket.items(), key=lambda kv: -kv[1][0])},
        "kernels": [{"name": k, "bucket": b, "ms": us / 1e3 / steps, "launches": n / steps}
                    for k, (us, n, b) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:topk]],
    }
    if events:
        print(f"device time: {out['device_ms']:.3f} ms/step ({steps} steps)\n\nby bucket:")
        for b, v in out["buckets"].items():
            print(f"  {v['ms']:9.3f} ms/step x{v['launches']:8.1f}  {b}")
        print(f"\ntop {topk} kernels:")
        for r in out["kernels"]:
            print(f"  {r['ms']:9.3f} ms/step x{r['launches']:8.1f}  {r['bucket']:<11} "
                  f"{r['name'][:100]}")
    return out


def breakdown(trace, steps=10, topk=25):
    """A JAX trace directory: JAX's per-step device-time table by (source,
    HLO category), printed. A torch.profiler Chrome trace: the dict of ms
    and launches a step by bucket and kernel (`steps` profiled steps),
    printed as a table too."""
    if isinstance(trace, str) and os.path.isdir(trace):
        return _xla_breakdown(trace, steps, topk)
    return _torch_breakdown(trace, steps, topk)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle(trace, top: int = 10) -> dict:
    """The device window (first device event's start to the last one's end):
    its ms, busy ms (the union of device events over every stream), idle
    share, and the `top` longest gaps between busy stretches, each with
    its ms, its start (ms into the window) and the innermost host operation
    (cpu_op / python_function / user_annotation) running at its start.
    None when the trace holds no device event."""
    tr = load_trace(trace)
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in _device_events(tr))
    if not busy:
        return None
    t0, t1 = busy[0][0], busy[-1][1]
    busy_us = sum(e - s for s, e in busy)
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in tr["traceEvents"]
                   if e.get("ph") == "X" and "dur" in e and e.get("cat") in _HOST_CATS))
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                  reverse=True)[:top]

    def label(t):
        inner = None
        for s, e, name in host:
            if s > t:
                break
            if e > t and (inner is None or s >= inner[0]):
                inner = (s, name)
        return None if inner is None else inner[1]

    window = t1 - t0
    return {"window_ms": window / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / window if window > 0 else 0.0,
            "gaps": [{"ms": g / 1e3, "at_ms": (s - t0) / 1e3, "host": label(s)}
                     for g, s in gaps]}



# ---- stage spans (core/spans.py): each device operation put down to the
# stage whose own time holds its launch; benchmark/spans.py holds a copy

_SPANS = ("rpc.train_step", "rpc.serve", "rpc.plan", "rpc.adversary", "rpc.encoder",
          "rpc.dense", "rpc.loss", "rpc.backward", "rpc.optimizer", "rpc.decode",
          "rpc.targets", "rpc.head")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


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


def _stage_table(tr, window=None):
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
                and e.get("name") in _SPANS and inside(e["ts"])):
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
        for a, b in _cut(s, e, _merge(children)):
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
        if e.get("name") in _SYNC_CALLS:
            syncs.append(float(e["ts"]))
    devs = [e for e in _device_events(tr) if inside(e["ts"])]
    mine = collections.defaultdict(list)
    for e in devs:
        t = launches.get(e.get("args", {}).get("correlation"))
        stage = None if t is None else stage_at(t)
        table[stage]["ops"] += 1
        mine[stage].append((e["ts"], e["ts"] + e["dur"]))
    for stage, ivs in mine.items():
        table[stage]["device_us"] = sum(b - a for a, b in _merge(ivs))
    for t in syncs:
        if inside(t):
            table[stage_at(t)]["syncs"] += 1
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in devs)
    for stage, row in table.items():
        if stage is not None:
            own = [(a, b) for a, b, _, name in segs if name == stage]
            row["idle_us"] = row["self_us"] - _overlap(own, busy)
    return table


def stages(trace, steps: int = 1) -> dict:
    """The port's stage spans over a whole torch.profiler trace, a step:
    {stage: {"spans", "self_ms", "ops", "device_ms", "idle_ms", "syncs"}},
    the stages in the order of core/spans.STAGES, then None for the
    operations launched outside every span; printed as a table too."""
    table = _stage_table(load_trace(trace))
    order = [n[4:] for n in _SPANS if n[4:] in table] + [None]
    out = {k: {"spans": table[k]["spans"] / steps, "self_ms": table[k]["self_us"] / 1e3 / steps,
               "ops": table[k]["ops"] / steps, "device_ms": table[k]["device_us"] / 1e3 / steps,
               "idle_ms": table[k]["idle_us"] / 1e3 / steps, "syncs": table[k]["syncs"] / steps}
           for k in order}
    print(f"{'stage':<12} {'self ms':>9} {'ops':>8} {'device ms':>9} {'idle ms':>9} "
          f"{'syncs':>6}  ({steps} steps)")
    for k, r in out.items():
        print(f"{k or '(no span)':<12} {r['self_ms']:9.3f} {r['ops']:8.1f} {r['device_ms']:9.3f} "
              f"{r['idle_ms']:9.3f} {r['syncs']:6.1f}")
    return out


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "stages":
        stages(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 1)
        raise SystemExit(0)
    if len(sys.argv) > 1 and sys.argv[1] == "breakdown":
        d = sys.argv[2] if len(sys.argv) > 2 else "work_dirs/trace_plan_base"
        steps = int(sys.argv[3]) if len(sys.argv) > 3 else 10
        breakdown(d, steps)
        raise SystemExit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "idle":
        print(json.dumps(idle(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 10),
                         indent=1))
        raise SystemExit(0)
    d = sys.argv[1] if len(sys.argv) > 1 else "work_dirs/diag_trace_plan"
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    summarize(d, k)
