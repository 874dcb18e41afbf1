"""host_ms_per_request: over the run's untraced calls, the mean
milliseconds a request's engine call took (host clock) beyond the device
seconds of its graph replays (``trace.ReplayClock``'s CUDA events): the
engine's validation, packing, copies and launches on the host."""


def read(ctx):
    calls = [c for c in ctx.calls if c.replay_s is not None]
    if not calls or sum(c.replay_s for c in calls) <= 0:
        return None
    host = sum(c.call_s - c.replay_s for c in calls)
    return 1e3 * host / sum(len(c.requests) for c in calls)
