"""The wall time of CenterPoint's head span (`rpc.head`: the CenterHead,
inside rpc.dense), ms a step or a batch on the trace's host clock, in the
traced steps."""
from benchmark import named_spans


def read(ctx):
    return named_spans.span_ms(ctx, "rpc.head")
