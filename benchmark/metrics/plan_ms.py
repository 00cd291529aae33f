"""The self time of the plan (`rpc.plan`: the inline voxelisation and index
plan, the sparse grid), ms a step or a batch on the trace's host clock: the
span's duration less the spans nested in it, in the traced steps."""
from benchmark import spans


def read(ctx):
    return spans.stage_ms(ctx, "plan")
