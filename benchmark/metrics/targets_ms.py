"""The wall time of CenterPoint's targets span (`rpc.targets`: the inline
heatmap and regression targets, inside the train step's root), ms a step
on the trace's host clock, in the traced steps."""
from benchmark import named_spans


def read(ctx):
    return named_spans.span_ms(ctx, "rpc.targets")
