"""encoder_row_use.<cells>: the share of the measures the frozen encoder
encoded that the requests needed: 100 x the program's counter
``encoder.rows_needed`` (the present context measures of the real rows, from
the engine's host masks) over ``encoder.rows`` (every measure slot of the
bucket, counted at the encoder's entry; a graph replay adds its capture's
count). The counters run from the process's start, so they hold the set-up's
calls beside the window's, from the same traffic. A program without them
reads nothing."""


def read(ctx):
    from inpaintnet_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    return 100.0 * c["encoder.rows_needed"] / c["encoder.rows"] if c["encoder.rows"] else None
