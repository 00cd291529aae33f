"""The trace readings on a hand-made Chrome trace with known answers."""
from benchmark import trace

TR = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 30},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 40, "dur": 50},
    {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 55, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void sparse_conv_tc_fwd_kernel<64>(...)", "ts": 10, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "stats_kernel(float const*)", "ts": 15, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>", "ts": 70, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 10},
]}


def test_window_and_busy():
    span = trace.window(TR)
    assert span == (0.0, 100.0)
    ev = trace.device_events(TR, span)
    assert len(ev) == 4
    # union: [10, 25] + [50, 55] + [70, 80] = 15 + 5 + 10
    assert trace.busy_us(ev, span) == 30.0


def test_buckets_and_top_ops():
    assert trace.bucket("void sparse_conv_tc_fwd_kernel<64>(...)") == "K1"
    assert trace.bucket("stats_kernel(float const*)") == "K2"
    assert trace.bucket("Memcpy HtoD", "gpu_memcpy") == "copies"
    assert trace.bucket("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    top = trace.top_ops(trace.device_events(TR, trace.window(TR)), steps=2, top=2)
    assert [round(s * 1e6, 6) for _, s in top] == [5.0, 5.0]


def test_idle_gaps_labelled_by_the_host_op():
    span = trace.window(TR)
    gaps = trace.idle_gaps(TR, trace.device_events(TR, span), span, top=3)
    # gaps: [0, 10] 10 us, [25, 50] 25 us, [55, 70] 15 us, [80, 100] 20 us
    assert [(h, round(s * 1e6, 6)) for h, s in gaps] == [
        ("aten::mul", 25.0), ("aten::add", 20.0), ("aten::inner", 15.0)]
