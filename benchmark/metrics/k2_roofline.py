"""K2 (the masked statistics and the fused masked batch norm,
kernels/masked_stats) against its roofline: the least time its launches a
step could take over their measured device time. Every launch is bound by
bytes: each valid row read once, each output row written once. A batch
norm in training: statistics (x), apply (x, y), backward reduce (g, x) and
dx (g, x, dx); in evaluation the apply alone. The adversary's two masked
statistics read its valid float32 rows; the statistic's VJP, where the
step launches it, reads them and writes their gradient."""
from benchmark import trace


def least_seconds(ctx, vjp_per_step: float) -> float:
    m = ctx.cfg["model"]
    enc = 2 if m["compute_dtype"] == "bfloat16" else 4
    adv = 2 if m.get("adversary_dtype", "float32") == "bfloat16" else 4
    train = ctx.kind == "train"
    totals = []
    for recs in ctx.records:
        b = 0.0
        for r in recs:
            if r["kind"] == "masked_bn":
                e = adv if r["adversary"] else enc
                b += (7 if train else 2) * r["rows"] * r["c"] * e
            elif r["kind"] == "perturber":
                b += 2 * r["rows"] * r["c"] * 4 + vjp_per_step * 2 * r["rows"] * r["c"] * 4
        totals.append(b / ctx.peaks["hbm_bytes_per_s"])
    return sum(totals) / len(totals)


def read(ctx):
    k2 = [e for e in ctx.events if trace.bucket(e.get("name", ""), e.get("cat")) == "K2"]
    if not k2 or not ctx.records:
        return None
    vjp = sum(1 for e in k2 if "vjp_kernel" in e.get("name", "")) / ctx.steps
    measured = sum(e["dur"] for e in k2) / 1e6 / ctx.steps
    return 100.0 * least_seconds(ctx, vjp) / measured
