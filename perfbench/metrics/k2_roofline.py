"""k2_roofline: the least time K2 (``ops/decode_kernel.py``, the 24-tick
argmax decode) could take on the target measures the traced requests ask
for, over its device time in the trace."""
from perfbench import flops

PATTERNS = (r"\bdecode_kernel\b",)


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds = sum(s for _, s in ctx.timeline.kernels(PATTERNS))
    if seconds <= 0:
        return None
    ops, moved = ctx.work["k2"]
    bound, by = flops.bound_s(ops, ctx.kind, moved)
    ctx.note(f"k2_roofline: bound by {by}: {ops!r} operations, {moved!r} bytes -> "
             f"{bound!r} s, against {seconds!r} s of K2")
    return 100.0 * bound / seconds
