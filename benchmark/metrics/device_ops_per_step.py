"""Device operations (kernels, copies, sets) a train step launches, in the
profiled steps' trace: the dispatch from the trainer down to the device."""


def read(ctx):
    if ctx.kind != "train" or not ctx.events:
        return None
    return len(ctx.events) / ctx.steps
