"""The self time of the decode and rotated NMS (`rpc.decode`), ms a step or a
batch on the trace's host clock: the span's duration less the spans nested
in it, in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ms(ctx, "decode")
