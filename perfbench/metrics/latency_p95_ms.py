"""latency_p95_ms: the 95th percentile, over every request of the window,
of the milliseconds from submitting it to the engine to its returned
tokens."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
