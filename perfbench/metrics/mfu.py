"""mfu.<cells>: the operations that the requests of the run's untraced
calls need (the whole model: ``reference/<family>.work``) over those
calls' cycles (host clock, from making each request to the end of copying
its rows out), at the card's dense peak for the served dtype
(``flops.PEAK_OPS``). The traced calls, which the profiler stretches, are
left out."""
from perfbench import flops


def read(ctx):
    if ctx.calls_work is None:
        return None
    seconds = sum(c.cycle_s for c in ctx.calls)
    peak = flops.PEAK_OPS[ctx.kind]
    ops = ctx.calls_work["model_ops"]
    ctx.note(f"mfu: {ops!r} operations over {seconds!r} s of {len(ctx.calls)} calls at "
             f"{peak!r} op/s")
    return 100.0 * ops / (seconds * peak)
