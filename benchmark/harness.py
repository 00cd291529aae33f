"""One run of one cell: set-up, the measured window, the traced steps, the
check against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, an entry or a
per-layer metric is found by name: `configs/<config>.json` (its "family"
names `program/<family>.py` and `reference/<family>.py`),
`traffic/<traffic>.json` (its "entry" names `entries/<entry>.py`),
`metrics/<metric>.py` or `metrics/<metric before its first dot>.py`, and
`limits/<workload>.json`."""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROFILED_STEPS = {"train": 5, "eval": 10}
PROFILED_FROM = 10_000  # the profiled steps' numbers, past any window's


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str, metrics_dir: str = os.path.join(HERE, "metrics")):
    """The reader module of a per-layer metric: metrics/<name>.py, else
    metrics/<name before its first dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(metrics_dir, stem + ".py")
        if os.path.isfile(path):
            mod_name = "benchmark_metric_" + stem.replace(".", "_").replace("-", "_")
            sp = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(sp)
            sp.loader.exec_module(mod)
            return mod
    raise SystemExit(f"no reader for the metric {name!r} under {metrics_dir}")


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_config(path: str) -> Dict:
    """A configuration file. One with a "base" (a file's path from the
    checkout's root) is that file with its own keys laid over it, group by
    group: the tests' small copies of a configuration."""
    cfg = load_json(path)
    if "base" not in cfg:
        return cfg
    return _merge(load_config(os.path.join(ROOT, cfg.pop("base"))), cfg)


def cell_parts(wl: Dict, bench: Dict, base: str = HERE):
    """(configuration, traffic, limits) files of a workload."""
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_config(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(base, "traffic", wl["traffic"] + ".json")
    limits_path = os.path.join(base, "limits", wl["name"] + ".json")
    limits = load_json(limits_path) if os.path.isfile(limits_path) else {}
    return cfg, traffic, limits


def device_pool(pool_np: List[Dict[str, np.ndarray]], device) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.as_tensor(v, device=device) for k, v in b.items()} for b in pool_np]


def make_context(cfg: Dict, traffic: Dict, seed: int, device: torch.device):
    """The inputs of a run: the pool of batches and the weights, both from the seed."""
    from . import scenes, weights

    ref_mod = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    skeleton = ref_mod.Reference(cfg, torch.device("cpu"))
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=seed, device=device,
        program=importlib.import_module(f"benchmark.program.{cfg['family']}"),
        reference=ref_mod,
        pool=device_pool(scenes.pool(seed, traffic), device),
        weights=weights.make(skeleton.model, seed, device,
                             float(traffic.get("class_logit_bias", weights.PRIOR))),
        sync=(lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None))
    del skeleton
    return ctx


def entry_class(traffic: Dict):
    return importlib.import_module(f"benchmark.entries.{traffic['entry']}").Entry


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def reference_precision(mode: str = "float32"):
    """TF32 off and the reference's products in `mode` (reference/plain/precision.py)."""
    from .reference.plain import precision

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with precision.use(mode):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_check(entry, ctx) -> Dict[str, float]:
    """The entry's check against the float32 reference built afresh on the device."""
    with reference_precision():
        return entry.check(ctx.reference.Reference(ctx.cfg, ctx.device))


def profile(entry, ctx, steps: int):
    """`steps` more steps under torch.profiler inside the window annotation;
    returns the Chrome trace as a dict."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    from . import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    with tprofile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            for n in range(steps):
                entry.step(PROFILED_FROM + n)
            ctx.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.load(path)
    finally:
        os.remove(path)


def layer_context(entry, ctx, tr: Dict, steps: int, step_s: float, peaks: Dict):
    from . import trace

    span = trace.window(tr)
    events = trace.device_events(tr, span) if span else []
    idx = sorted({entry.pool_index(PROFILED_FROM + n) for n in range(steps)})
    return types.SimpleNamespace(
        kind=entry.kind, cfg=ctx.cfg, traffic=ctx.traffic, peaks=peaks, steps=steps,
        events=events, span=span, trace=tr, step_s=step_s,
        window_us=(span[1] - span[0]) if span else 0.0,
        busy_us=trace.busy_us(events, span) if events else 0.0,
        pool_indices=idx, records=None)


def fill_records(lctx, ctx) -> None:
    """The reference's launch records of each profiled batch (counts.record)."""
    from . import counts

    ref = ctx.reference.Reference(ctx.cfg, ctx.device)
    ref.model.load_state_dict(ctx.weights)
    ref.model.eval()
    lctx.records = [counts.record(ref.model, lambda b=ctx.pool[i]: ref.eval_heads(b))
                    for i in lctx.pool_indices]
    del ref


def run(workload_name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: Optional[torch.device] = None, bench: Optional[Dict] = None,
        base: str = HERE) -> Dict:
    """One run; returns the result line's object."""
    from . import trace

    bench = bench or spec()
    wl = workload(workload_name, bench)
    cfg, traffic, limits = cell_parts(wl, bench, base)
    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = make_context(cfg, traffic, seed, device)
    entry = entry_class(traffic)(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    win = entry.window(seconds, ctx.sync)
    frames = win["steps"] * entry.frames_per_step
    result_metrics: Dict[str, Dict] = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1}
    step_s = win["seconds"] / max(win["steps"], 1)
    lctx = None
    if traced:
        steps = PROFILED_STEPS[entry.kind]
        tr = profile(entry, ctx, steps)
        lctx = layer_context(entry, ctx, tr, steps, step_s, load_json(HERE, "peaks.json"))
    else:
        rate = frames / win["seconds"]
        if entry.kind == "train":
            result_metrics["train_fps"] = {"value": rate, "unit": "frames/s"}
        else:
            result_metrics["eval_fps"] = {"value": rate, "unit": "frames/s"}
            p95 = float(np.percentile(np.asarray(win["latencies"]) * 1e3, 95))
            result_metrics["eval_batch_p95_ms"] = {"value": p95, "unit": "ms"}
        result_metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                        if device.type == "cuda" else 0)

    entry.release()
    free(device)
    t_ref = time.perf_counter()
    numbers = reference_check(entry, ctx)
    free(device)
    print(f"reference check: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)

    breakdown = None
    if traced:
        fill_records(lctx, ctx)
        for m in bench["per_layer"]:
            if workload_name not in m.get("workloads", [workload_name]):
                continue
            v = metric_reader(m["name"]).read(lctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = lctx.busy_us / 1e6
        device_info["window_s"] = lctx.window_us / 1e6
        if lctx.events:
            breakdown = {"device_ops": trace.top_ops(lctx.events, lctx.steps),
                         "idle_gaps": trace.idle_gaps(lctx.trace, lctx.events, lctx.span)}

    from . import check

    if set(limits) - set(numbers):
        raise SystemExit(f"limits for numbers the check does not make: {sorted(set(limits) - set(numbers))}")
    compared = {k: numbers[k] for k in limits}
    correct = bool(compared) and check.judge(compared, limits)
    out = {"correct": correct, "attempted": win["steps"], "failed": 0,
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    return out


def report_checks(out: Dict, stream=sys.stderr) -> None:
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=stream)
