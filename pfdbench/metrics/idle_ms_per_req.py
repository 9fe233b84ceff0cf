"""Device idle ms inside each traced request's span (call to images in host
memory), the mean over the traced requests: the facade's host path."""


def read(ctx):
    if not ctx.trace.device or not ctx.trace.requests:
        return None
    idle = [sum(e - s for s, e in ctx.trace.idle_gaps(t0, t1)) / 1e3
            for t0, t1 in ctx.trace.requests]
    return sum(idle) / len(idle)
