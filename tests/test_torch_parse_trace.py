"""tools/parse_trace: JAX's parse_xplane functions, copied, give JAX's output
on traces in JAX's layout; the torch.profiler layout's device time,
breakdown and idle gaps on a hand-built trace with known answers, and None
on a real CPU-only trace."""
import gzip
import json
import os

import pytest
import torch

from robustpointclouds_tpu.tools import parse_xplane as jpx
from robustpointclouds_tpu_torch.tools import parse_trace as pt
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)


def _xla_events(scale: float):
    """A JAX-layout capture: a TPU device pid with its module, op and step
    lines, a second device pid, and a host pid."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:TPU:1"}},
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3, "args": {"name": "Steps"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 1, "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 2, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 9, "args": {"name": "python"}},
    ]
    x = []
    for i in range(3):
        t = 1000.0 * i
        x.append({"ph": "X", "pid": 1, "tid": 1, "ts": t, "dur": 800 * scale,
                  "name": "jit_scan_steps(123)"})
        x.append({"ph": "X", "pid": 1, "tid": 3, "ts": t, "dur": 810 * scale,
                  "name": "jit_scan_steps(123)"})  # a step line with the module's name
        x.append({"ph": "X", "pid": 2, "tid": 1, "ts": t, "dur": 400 * scale,
                  "name": "jit_scan_steps(123)"})
        x.append({"ph": "X", "pid": 2, "tid": 1, "ts": t + 500, "dur": 50 * scale,
                  "name": "jit_other(9)"})
        for j, (cat, src, flops, nbytes) in enumerate((
                ("convolution", "/repo/robustpointclouds_tpu/ops/subm_conv.py:120", 3e9, 2e8),
                ("custom fusion", "/repo/robustpointclouds_tpu/ops/sparse.py:410", 0, 5e8),
                ("data formatting", "", 0, 1e8),
                ("while", "/x/y/z.py:1", 0, 0),
                ("convolution", "/repo/robustpointclouds_tpu/ops/subm_conv.py:120", 1e9, 1e8))):
            x.append({"ph": "X", "pid": 1 + (j % 2), "tid": 2, "ts": t + 10 * j,
                      "dur": (100 + 10 * j) * scale, "name": f"fusion.{j}",
                      "args": {"hlo_category": cat, "source": src, "model_flops": flops,
                               "raw_bytes_accessed": nbytes}})
        x.append({"ph": "X", "pid": 7, "tid": 9, "ts": t, "dur": 900, "name": "PjitFunction"})
    return meta + x


@pytest.fixture(scope="module")
def xla_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("xla_trace")
    for run, scale in (("2026_01_01_00_00_00", 3.0), ("2026_02_01_00_00_00", 1.0)):
        d = root / "plugins" / "profile" / run
        d.mkdir(parents=True)
        for host in ("host_a", "host_b"):
            with gzip.open(d / f"{host}.trace.json.gz", "wt") as f:
                json.dump({"traceEvents": _xla_events(scale if host == "host_a" else 2 * scale)},
                          f)
    return str(root)


def test_summarize_matches_jax(xla_dir, capsys):
    jpx.summarize(xla_dir, 5)
    ref = capsys.readouterr().out
    pt.summarize(xla_dir, 5)
    assert capsys.readouterr().out == ref
    assert "fusion.0" in ref and "PjitFunction" in ref


def test_device_module_ms_and_op_events_match_jax(xla_dir):
    assert pt._latest_trace_paths(xla_dir) == jpx._latest_trace_paths(xla_dir)
    assert len(pt._latest_trace_paths(xla_dir)) == 2  # the newest capture only
    for name in ("scan_steps", "other", "absent"):
        assert pt.device_module_ms(xla_dir, name) == jpx.device_module_ms(xla_dir, name)
    # the module line only (the step line would double count), newest capture,
    # both device pids: 3 x (800 + 400) x (1 + 2) us
    assert pt.device_module_ms(xla_dir, "scan_steps") == pytest.approx(3 * 1200 * 3 / 1e3)
    assert pt.device_module_ms(xla_dir, "absent") is None
    assert list(pt._device_op_events(xla_dir)) == list(jpx._device_op_events(xla_dir))


@pytest.mark.parametrize("steps", [1, 3])
def test_breakdown_matches_jax(xla_dir, capsys, steps):
    jpx.breakdown(xla_dir, steps, topk=4)
    ref = capsys.readouterr().out
    assert pt.breakdown(xla_dir, steps, topk=4) is None
    assert capsys.readouterr().out == ref
    assert "custom fusion" in ref and "while" not in ref


def test_missing_trace_raises_as_jax(tmp_path):
    with pytest.raises(SystemExit):
        jpx.summarize(str(tmp_path))
    with pytest.raises(SystemExit):
        pt.summarize(str(tmp_path))
    assert pt.device_module_ms(str(tmp_path)) is None


def _torch_trace():
    """A torch.profiler-layout trace: two streams' kernels, a copy, host ops."""
    def dev(name, ts, dur, cat="kernel", tid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}

    def host(name, ts, dur, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": 100, "ts": ts, "dur": dur}

    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "CUDA"}},
        dev("void sparse_conv_tc_fwd_kernel<16, 16>(x)", 1000, 100),
        dev("void stats_kernel<float, 4>(x)", 1100, 20),
        dev("void apply_kernel<__nv_bfloat16>(x)", 1150, 30, tid=8),  # gap 1120-1150
        dev("Memcpy HtoD (Pageable -> Device)", 1300, 50, cat="gpu_memcpy"),  # gap 1180-1300
        dev("void at::native::vectorized_elementwise_kernel<4>(x)", 1340, 20),  # overlaps
        dev("sm90_xmma_fprop_implicit_gemm_bf16", 1400, 100),  # gap 1360-1400
        dev("void sparse_conv_tc_wgrad_kernel<16, 16>(x)", 1500, 100),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#1", "pid": 0, "tid": 9,
         "ts": 900, "dur": 800},
        host("aten::train_step", 900, 800, cat="user_annotation"),
        host("aten::matmul", 1110, 100),
        host("aten::mm", 1115, 30),
        host("aten::copy_", 1170, 150),
        host("rpc::sparse_conv_fwd", 1350, 60),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 100, "tid": 100,
         "ts": 1355, "dur": 5},
    ]}


def test_torch_device_ms_breakdown_and_idle(tmp_path, capsys):
    tr = _torch_trace()
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(tr, f)
    for trace in (tr, str(path)):
        assert pt.device_ms(trace) == pytest.approx(0.42)
        assert pt.device_ms(trace, "sparse_conv") == pytest.approx(0.2)
        bd = pt.breakdown(trace, steps=2)
        assert bd["device_ms"] == pytest.approx(0.21)
        assert {k: round(v["ms"], 6) for k, v in bd["buckets"].items()} == {
            "K1": 0.1, "K2": 0.025, "conv": 0.05, "copies": 0.025, "elementwise": 0.01}
        assert bd["buckets"]["K1"]["launches"] == 1.0
        assert bd["kernels"][0]["bucket"] == "K1"
        idle = pt.idle(trace, top=2)
        # window 1000-1600, busy 1000-1120, 1150-1180, 1300-1360, 1400-1600
        assert idle["window_ms"] == pytest.approx(0.6)
        assert idle["busy_ms"] == pytest.approx(0.41)
        assert idle["idle_share"] == pytest.approx(0.19 / 0.6)
        assert [(round(g["ms"], 6), round(g["at_ms"], 6), g["host"]) for g in idle["gaps"]] == [
            (0.12, 0.18, "aten::copy_"), (0.04, 0.36, "rpc::sparse_conv_fwd")]
    assert "K1" in capsys.readouterr().out


def test_cpu_profiler_trace_has_no_device_time(tmp_path):
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (x @ x).sum()
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    assert os.path.getsize(path) > 0
    assert pt.device_ms(path) is None
    assert pt.idle(path) is None
    assert pt.breakdown(path, steps=1)["device_ms"] is None


def test_torch_stages_by_span(capsys):
    """The stage spans' self time, the device operations put down to the
    span whose self time holds their launch (the autograd thread's to the
    main thread's backward, one launched outside every span to none), their
    device ms, the idle ms in each span and its syncs, a step."""
    def span(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 100, "tid": tid,
                "ts": ts, "dur": dur}

    def call(name, ts, corr=None, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 100, "tid": tid,
                "ts": ts, "dur": 2, "args": {} if corr is None else {"correlation": corr}}

    def dev(ts, dur, corr, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "void stats_kernel<float>(x)", "pid": 0,
                "tid": 7, "ts": ts, "dur": dur, "args": {"correlation": corr}}

    tr = {"traceEvents": [
        span("rpc.train_step", 0, 1000), span("rpc.plan", 100, 200),
        span("rpc.backward", 400, 400),
        call("cudaLaunchKernel", 50, 1), dev(60, 20, 1),                 # the root's own
        call("cudaLaunchKernel", 150, 2), dev(160, 40, 2),               # plan
        call("cudaLaunchKernel", 180, 3), dev(190, 40, 3),               # plan, overlapping
        call("cudaLaunchKernel", 500, 4, tid=2), dev(510, 100, 4),       # backward, thread 2
        call("cudaMemcpyAsync", 1100, 5), dev(1110, 10, 5, "gpu_memcpy"),  # no span
        call("cudaStreamSynchronize", 600), call("cudaStreamSynchronize", 1200),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "rpc.plan", "pid": 0, "tid": 8,
         "ts": 160, "dur": 90},
    ]}
    out = pt.stages(tr, steps=2)
    assert list(out) == ["train_step", "plan", "backward", None]
    assert out["train_step"]["self_ms"] == pytest.approx(0.2)  # 1000 - 200 - 400 us
    assert out["plan"]["self_ms"] == pytest.approx(0.1)
    assert [out[k]["ops"] for k in out] == [0.5, 1.0, 0.5, 0.5]
    assert out["plan"]["device_ms"] == pytest.approx(0.035)  # [160, 230) a step
    assert out["plan"]["idle_ms"] == pytest.approx(0.065)  # 200 - 70 us
    assert out["train_step"]["idle_ms"] == pytest.approx(0.19)  # 400 - 20 us
    assert out["backward"]["syncs"] == 0.5 and out[None]["syncs"] == 0.5
    assert "backward" in capsys.readouterr().out
