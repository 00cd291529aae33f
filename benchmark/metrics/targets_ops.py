"""The device operations (kernels, copies, sets) a step or a batch launched
inside CenterPoint's targets span (`rpc.targets`), in the traced steps."""
from benchmark import named_spans


def read(ctx):
    return named_spans.span_ops(ctx, "rpc.targets")
