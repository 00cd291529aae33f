"""The self time of the dense body: backbone, neck and head (`rpc.dense`), ms a
step or a batch on the trace's host clock: the span's duration less the
spans nested in it, in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ms(ctx, "dense")
