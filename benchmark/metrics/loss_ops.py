"""The device operations (kernels, copies, sets) a step or a batch launched
while the host was in the self time of the losses (`rpc.loss`: the on-device
anchor assignment, the detection loss, the adversary's terms, the NaN
guard), in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ops(ctx, "loss")
