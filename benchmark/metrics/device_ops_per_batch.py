"""Device operations (kernels, copies, sets) an evaluation batch launches,
in the profiled batches' trace: the dispatch from the serving function down
to the device."""


def read(ctx):
    if ctx.kind != "eval" or not ctx.events:
        return None
    return len(ctx.events) / ctx.steps
