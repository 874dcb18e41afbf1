"""k7_roofline: the least time K7 (``ops/arnn_kernel.py``: the context GEMM
and the 384-tick decode with forced ticks) could take on the traced
requests, over its device time in the trace."""
from perfbench import flops

PATTERNS = (r"\barnn_kernel\b", r"\bencoder_xw_gemm_split_kernel<1>")


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds = sum(s for _, s in ctx.timeline.kernels(PATTERNS))
    if seconds <= 0:
        return None
    ops, moved = ctx.work["k7"]
    bound, by = flops.bound_s(ops, ctx.kind, moved)
    ctx.note(f"k7_roofline: bound by {by}: {ops!r} operations, {moved!r} bytes -> "
             f"{bound!r} s, against {seconds!r} s of K7")
    return 100.0 * bound / seconds
