"""graph_capture_s: seconds the engine spent on the cell's CUDA graphs in
set-up (``graphs.CapturedCall``: the eager run before capture and the
capture), a counter the program keeps."""


def read(ctx):
    return ctx.counters.get("graph_capture_s")
