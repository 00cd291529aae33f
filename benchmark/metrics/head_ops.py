"""The device operations (kernels, copies, sets) a step or a batch launched
inside CenterPoint's head span (`rpc.head`), in the traced steps."""
from benchmark import named_spans


def read(ctx):
    return named_spans.span_ops(ctx, "rpc.head")
