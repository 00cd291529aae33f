"""The device operations (kernels, copies, sets) a step or a batch launched
while the host was in the self time of the dense body: backbone, neck and
head (`rpc.dense`), in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ops(ctx, "dense")
