"""k1_roofline: the least time K1 (``ops/encoder_kernel.py``: both layers'
recurrences and the layer-1 projection GEMM) could take on the measures
the traced requests fill, over its device time in the trace."""
from perfbench import flops

PATTERNS = (r"\bencoder_rec_kernel\b", r"\bencoder_xw_gemm_kernel\b")


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds = sum(s for _, s in ctx.timeline.kernels(PATTERNS))
    if seconds <= 0:
        return None
    ops, moved = ctx.work["k1"]
    bound, by = flops.bound_s(ops, ctx.kind, moved)
    ctx.note(f"k1_roofline: bound by {by}: {ops!r} operations, {moved!r} bytes -> "
             f"{bound!r} s, against {seconds!r} s of K1")
    return 100.0 * bound / seconds
