"""setup_s: seconds from the run's start to the window's, on the host's
clock: interpreter imports, the weights, the engine's copies, the kernel
library (built in a checkout's first run, loaded after), the cell's graph
capture and its first replay."""


def read(ctx):
    return ctx.setup_s
