"""K1 (the sparse conv's gather-GEMMs, kernels/sparse_conv) against its
roofline: the least time its launches a step could take over their measured
device time. A launch's least time is the larger of its bytes over the HBM
rate and its operations over the route's peak (bfloat16: the bf16 peak;
float32: the 3xTF32 route's three products on the TF32 peak). Bytes: each
input row the launch reads once (valid rows only), the weights, the index
rows, each output row written once. Operations: 2 x hits x Cin x Cout per
forward, dgrad and wgrad."""
from benchmark import trace


def conv_seconds(r, train: bool, elem: int, peak: float, bw: float) -> float:
    taps, cin, cout = r["taps"], r["cin"], r["cout"]
    flops = 2.0 * r["hits"] * cin * cout
    w = taps * cin * cout * elem
    fwd = r["rows_in"] * cin * elem + w + r["rows_out"] * taps * 4 + r["rows_out"] * cout * elem
    launches = [fwd]
    if train:
        dgrad = r["rows_out"] * cout * elem + w + r["rows_in"] * taps * 4 + r["rows_in"] * cin * elem
        wgrad = (r["rows_in"] * cin * elem + r["rows_out"] * cout * elem + r["rows_out"] * taps * 4
                 + taps * cin * cout * 4)
        launches += [dgrad, wgrad]
    return sum(max(b / bw, flops / peak) for b in launches)


def least_seconds(ctx) -> float:
    bf16 = ctx.cfg["model"]["compute_dtype"] == "bfloat16"
    elem = 2 if bf16 else 4
    peak = ctx.peaks["bf16_flops"] if bf16 else ctx.peaks["tf32_flops"] / 3.0
    bw = ctx.peaks["hbm_bytes_per_s"]
    total = [sum(conv_seconds(r, ctx.kind == "train", elem, peak, bw)
                 for r in recs if r["kind"] == "sparse_conv") for recs in ctx.records]
    return sum(total) / len(total)


def read(ctx):
    k1 = [e for e in ctx.events if trace.bucket(e.get("name", ""), e.get("cat")) == "K1"]
    if not k1 or not ctx.records:
        return None
    measured = sum(e["dur"] for e in k1) / 1e6 / ctx.steps
    return 100.0 * least_seconds(ctx) / measured
