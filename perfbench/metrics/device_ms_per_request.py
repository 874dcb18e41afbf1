"""device_ms_per_request: milliseconds in which the device was busy in the
traced window, over the requests traced."""


def read(ctx):
    t = ctx.timeline
    if t is None or t.busy_s <= 0 or not ctx.traced:
        return None
    return 1e3 * t.busy_s / len(ctx.traced)
