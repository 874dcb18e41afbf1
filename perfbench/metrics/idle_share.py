"""idle_share.<cells>: the share of the run's untraced calls in which the
card was not replaying the cell's graphs: 1 - the replays' device seconds
(``trace.ReplayClock``'s CUDA events) over the calls' cycles (host clock,
from making each request to the end of copying its rows out). The host's
work between and around replays, and the copies in and out, count as
idle. A run that replays no graph reads nothing."""


def read(ctx):
    calls = [c for c in ctx.calls if c.replay_s is not None]
    busy = sum(c.replay_s for c in calls)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / sum(c.cycle_s for c in calls))
