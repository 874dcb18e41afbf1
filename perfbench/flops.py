"""The yardstick: published peaks of the card, and the operations and bytes
that a request needs, counted from shapes.

The peaks and the counts of ``encoder_ops``, ``decode_ops`` and
``arnn_ops`` are frozen copies of ``chip_smoke.py``'s (``PEAK_OPS``,
``PEAK_BYTES``, ``bound_of``): the kernel table's bounds (K1 20.01 ms at
65,536 rows, K2 1.50 ms at 12,288, K7 0.45 ms at 512 x 384) come from them.
The rest extends them to the layers around the kernels, so that a step's
share of the peak (``mfu``) counts the whole model.

Every count is of multiply-adds x 2 of the products (the gate arithmetic
is left out), and of what the inputs need: a padded slot or a padded
target step that the program computes anyway is not counted.
"""
from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data
# sheet): operations per second by product type, and HBM bytes per second.
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, kind: str, moved: float) -> tuple:
    """The least time the card could take: the larger of ``ops`` at the
    peak rate of their ``kind`` and ``moved`` bytes (each input read once,
    each output written once) at the memory rate. -> (seconds, "operations"
    or "bytes", the one that bounds it)."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], moved / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gru_stack_ops(rows: int, steps: int, inp: int, hidden: int, layers: int,
                  dirs: int) -> float:
    """A GRU stack over ``steps`` steps: per step, direction and layer the
    (in, 3H) input product and the (H, 3H) recurrent one."""
    total = 0.0
    for layer in range(layers):
        width = inp if layer == 0 else hidden * dirs
        total += dirs * 3 * hidden * (width + hidden)
    return 2.0 * rows * steps * total


def lstm_stack_ops(rows: int, steps: int, inp: int, hidden: int, layers: int) -> float:
    """A one-direction LSTM stack: per step and layer the (in, 4H) and the
    (H, 4H) products."""
    total = 0.0
    for layer in range(layers):
        total += 4 * hidden * ((inp if layer == 0 else hidden) + hidden)
    return 2.0 * rows * steps * total


def encoder_ops(rows: int, steps: int, hidden: int) -> float:
    """K1: multiply-adds x 2 of the 2-layer bidirectional encoder per call:
    per step and direction, layer 0's recurrent (H, 3H) product (its input
    projection is a table row) and layer 1's recurrent and (2H, 3H) input
    products (``chip_smoke.encoder_ops``)."""
    return 2.0 * steps * rows * 2 * (hidden * 3 * hidden + 3 * hidden * 3 * hidden)


def encoder_bytes(rows: int, steps: int, hidden: int, emb: int, vocab: int,
                  elem: int = 2) -> float:
    """K1's bytes: the int32 tokens and the weights in, the four final
    hiddens out."""
    weights = 2 * (vocab * emb + emb * 3 * hidden + 3 * hidden * hidden
                   + 2 * hidden * 3 * hidden + 3 * hidden * hidden + 4 * 3 * hidden)
    return rows * steps * 4 + weights * elem + 4 * rows * hidden * elem


def encoder_heads_ops(rows: int, hidden: int, z_dim: int) -> float:
    """The mean and log-std heads: (4H, 2H) and (2H, z) each."""
    return 2.0 * rows * 2 * (4 * hidden * 2 * hidden + 2 * hidden * z_dim)


def decode_ops(rows: int, hidden: int, vocab: int) -> float:
    """K2: multiply-adds x 2 of the 24-tick 2-layer decode per call: three
    (H, 3H) products and the (H, V) head per tick, and the per-beat context
    projection (``chip_smoke.decode_ops``)."""
    return 2.0 * rows * (24 * (3 * hidden * 3 * hidden + hidden * vocab)
                         + 4 * hidden * 3 * hidden)


def decode_bytes(rows: int, hidden: int, vocab: int, emb: int, elem: int = 2) -> float:
    """K2's bytes: the beat contexts and tick hiddens in (4 beats, 3H of
    context projection, 2 layers of H), the weights in, the tokens (int32)
    and logits out."""
    weights = (vocab * emb + emb * 3 * hidden + 3 * hidden * hidden * 3 + hidden * vocab
               + 4 * 3 * hidden + vocab)
    inputs = rows * 4 * (3 * hidden + 2 * hidden)
    outputs = rows * 24 * (4 + vocab * elem)
    return (weights + inputs) * elem + outputs


def decoder_prelude_ops(rows: int, hidden: int, z_dim: int) -> float:
    """The decode's work outside K2: z to the beat GRU's hiddens (z, 2H),
    the 4-step 2-layer beat GRU (input width 1), and per beat the tick
    GRU's init hiddens (H, 2H) and its input context (H, H)."""
    beat = gru_stack_ops(rows, 4, 1, hidden, 2, 1)
    return (2.0 * rows * z_dim * 2 * hidden + beat
            + 2.0 * rows * 4 * (hidden * 2 * hidden + hidden * hidden))


def arnn_ops(rows: int, ticks: int, hidden: int, ctx: int, linear: int, vocab: int) -> float:
    """K7: multiply-adds x 2 per call: per row and tick, layer 0's (C, 4H)
    context and (H, 4H) recurrent products, layer 1's two (H, 4H) products,
    and the head's (H, L) and (L, V) products (``chip_smoke.arnn_ops``)."""
    return 2.0 * rows * ticks * (4 * hidden * (ctx + 3 * hidden) + hidden * linear
                                 + linear * vocab)


def arnn_bytes(rows: int, ticks: int, hidden: int, ctx: int, linear: int, vocab: int,
               emb: int, elem: int = 2) -> float:
    """K7's bytes: the constraint outputs, tokens and force mask in, the
    weights in, the tokens (int32) and logits out."""
    weights = (4 * hidden * (ctx + emb + 3 * hidden) + hidden * linear + linear * vocab
               + (vocab + 1) * emb)
    inputs = rows * ticks * (ctx * elem + 4 + 4)
    outputs = rows * ticks * (4 + vocab * elem)
    return weights * elem + inputs + outputs
