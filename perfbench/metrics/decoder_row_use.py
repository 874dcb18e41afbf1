"""decoder_row_use.<cells>: the share of the measures the decoder decoded
that the requests asked for: 100 x the program's counter
``decoder.rows_needed`` (the target measures of the real rows, from the
engine's host masks) over ``decoder.rows`` (``max_target`` slots a row of the
bucket, counted at ``decode_sampling``'s entry; a graph replay adds its
capture's count). The counters run from the process's start, so they hold
the set-up's calls beside the window's, from the same traffic. A program
without them reads nothing."""


def read(ctx):
    from inpaintnet_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    return 100.0 * c["decoder.rows_needed"] / c["decoder.rows"] if c["decoder.rows"] else None
