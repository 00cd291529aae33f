"""The whole step's share of the chip's bfloat16 peak: the FLOPs the work
needs, counted from the configuration's widths and the reference's plan
(sparse convs by neighbour hits, dense convs and transposed convs by shape,
the adversary's linears over valid points; 2 x multiply-adds a forward, 3 x
the forward for a train step), over the wall time of a step of the
unprofiled window."""
from benchmark.counts import forward_flops


def flops_per_step(ctx) -> float:
    per = [forward_flops(r) for r in ctx.records]
    f = sum(per) / len(per)
    return 3.0 * f if ctx.kind == "train" else f


def read(ctx):
    if not ctx.records or ctx.step_s <= 0:
        return None
    return 100.0 * flops_per_step(ctx) / ctx.step_s / ctx.peaks["bf16_flops"]
