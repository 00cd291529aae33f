"""The device operations (kernels, copies, sets) a step or a batch launched
while the host was in the self time of the backward and the gradients' NaN
sanitation (`rpc.backward`; the autograd thread's launches count here), in
the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ops(ctx, "backward")
