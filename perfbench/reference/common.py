"""Plain PyTorch pieces of the references: linear maps, GRU and LSTM
stacks in torch's gate orders ([r, z, n], [i, f, g, o]) and parameter
names (``weight_ih_l{k}[_reverse]`` (G*H, in), ...), float32 with TF32 off.

``Prec`` carries the precision the products are computed in: float32
(the reference), or, for a control, each operand of every product rounded
to float8 e4m3 first, with a scale per row of the data and per output
channel of the weights (``round_fp8``).
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale along ``dim``'s slices
    (its largest magnitude maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """The precision of the products: ``"f32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {kind!r}")
        self.kind = kind

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """``x @ w.T + b`` for w (out, in)."""
        if self.kind == "fp8":
            x = round_fp8(x, -1)
            w = round_fp8(w, 1)
        y = x @ w.t()
        return y if b is None else y + b


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gru_dir(w: dict, sfx: str, x: torch.Tensor, h: torch.Tensor, reverse: bool,
            prec: Prec) -> tuple:
    """One direction of one GRU layer over x (B, T, in) from h (B, H)
    -> (outputs (B, T, H), last h)."""
    hid = h.shape[-1]
    xw = prec.linear(x, w["weight_ih" + sfx], w["bias_ih" + sfx])
    out = [None] * x.shape[1]
    order = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in order:
        hw = prec.linear(h, w["weight_hh" + sfx], w["bias_hh" + sfx])
        r = torch.sigmoid(xw[:, t, :hid] + hw[:, :hid])
        z = torch.sigmoid(xw[:, t, hid:2 * hid] + hw[:, hid:2 * hid])
        n = torch.tanh(xw[:, t, 2 * hid:] + r * hw[:, 2 * hid:])
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1), h


def gru_stack(w: dict, x: torch.Tensor, h0: list, layers: int, bidirectional: bool,
              prec: Prec) -> tuple:
    """A GRU stack over x (B, T, in); ``h0`` one (B, H) a (layer, direction),
    directions fastest. -> (last layer's outputs (B, T, H * dirs), final
    hiddens in the same order as ``h0``)."""
    dirs = 2 if bidirectional else 1
    finals = []
    for layer in range(layers):
        outs = []
        for d in range(dirs):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            o, h = gru_dir(w, sfx, x, h0[layer * dirs + d], d == 1, prec)
            outs.append(o)
            finals.append(h)
        x = torch.cat(outs, dim=-1)
    return x, finals


def lstm_step(w: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              prec: Prec) -> tuple:
    """One LSTM step of a layer whose parameters are ``w`` (``*_l0``)."""
    hid = h.shape[-1]
    g = (prec.linear(x, w["weight_ih_l0"], w["bias_ih_l0"])
         + prec.linear(h, w["weight_hh_l0"], w["bias_hh_l0"]))
    i = torch.sigmoid(g[:, :hid])
    f = torch.sigmoid(g[:, hid:2 * hid])
    gg = torch.tanh(g[:, 2 * hid:3 * hid])
    o = torch.sigmoid(g[:, 3 * hid:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


def sub(weights: dict, prefix: str) -> dict:
    """The entries of ``weights`` under ``prefix``, with it taken off."""
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


def gru_specs(prefix: str, inp: int, hidden: int, layers: int, bidirectional: bool) -> list:
    """(name, shape, kind) of a GRU stack's parameters."""
    dirs = 2 if bidirectional else 1
    out = []
    for layer in range(layers):
        width = inp if layer == 0 else hidden * dirs
        for d in range(dirs):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            out += [(f"{prefix}weight_ih{sfx}", (3 * hidden, width), "matrix"),
                    (f"{prefix}weight_hh{sfx}", (3 * hidden, hidden), "matrix"),
                    (f"{prefix}bias_ih{sfx}", (3 * hidden,), "bias"),
                    (f"{prefix}bias_hh{sfx}", (3 * hidden,), "bias")]
    return out


def linear_specs(prefix: str, inp: int, out: int) -> list:
    return [(f"{prefix}weight", (out, inp), "matrix"), (f"{prefix}bias", (out,), "bias")]


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far below each position's best logit the logit of ``tokens``
    lies: (..., V), (...) -> (...)."""
    picked = logits.gather(-1, tokens.long()[..., None])[..., 0]
    return logits.max(dim=-1).values - picked
