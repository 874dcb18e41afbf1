"""launches_per_request: kernels the device ran in the traced window, over
the requests traced (a count: it repeats exactly while the program's
launch sequence does)."""


def read(ctx):
    t = ctx.timeline
    if t is None or t.busy_s <= 0 or not ctx.traced:
        return None
    return t.launches() / len(ctx.traced)
