"""The share of the profiled steps' wall time in which no device operation
ran: 1 - (union of device intervals) / (the window's host-clock length)."""


def read(ctx):
    if not ctx.events or ctx.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
