"""measures_per_s, and each measures_per_s.<family> that has no file of
its own: target measures returned in the window (every tune's span) over
the window's seconds (host clock, first call's start to last call's
return)."""


def read(ctx):
    return ctx.measures / ctx.window_s
