"""The self time of the losses (`rpc.loss`: the on-device anchor assignment,
the detection loss, the adversary's terms, the NaN guard), ms a step or a
batch on the trace's host clock: the span's duration less the spans nested
in it, in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ms(ctx, "loss")
