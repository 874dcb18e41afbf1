"""Plain reference of the AnticipationRNN baseline's inpainting (Hadjeres
and Nielsen, "Anticipation-RNN", 2018; the parameter names and shapes of
InpaintNet's PyTorch baseline), in float32, or with every product's
operands rounded to float8 for the control.

For a served row (its input tune of M measures, its span) and the tokens
the program returned:

1. the position metadata of each tick: a beat marker (downbeat at tick 0
   of a measure, beat at ticks 6, 12 and 18, slur elsewhere, indexed in
   the sorted symbol order B, XX, __, b), the tick within its beat (0-5)
   and the voice id (0);
2. the unary constraints: a tick inside the span becomes the extra
   "no constraint" token (the vocabulary size), the others keep the input;
3. the constraint LSTM stack (2 layers) runs over the reversed ticks on
   [the three metadata embeddings, the constraint's note embedding];
4. the generation LSTM stack (2 layers) runs teacher-forced on the served
   tokens: tick t reads [the note embedding of the served token at t - 1
   (START's at tick 0), the constraint output at t]; ReLU(Linear) and a
   Linear give the logits.

The compared numbers: the widest gap by which a served token's logit in
the span lies below the reference's best there, and the count of ticks
outside the span that differ from the input (they are forced). The
control reads, at the same positions, the gap of the token that the
float8 reference puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import flops
from perfbench.reference.common import Prec, exact_f32, gaps, linear_specs, lstm_step

TICKS_PER_MEASURE = 24
TICKS_PER_BEAT = 6
# sorted(["XX", "__", "b", "B"]): downbeat B, pad XX, slur __, beat b
DOWNBEAT, SLUR, BEAT = 0, 2, 3


def param_specs(cfg: dict) -> list:
    V, E, D = cfg["vocab_size"], cfg["note_embedding_dim"], cfg["metadata_embedding_dim"]
    C, G, Lin = (cfg["num_lstm_constraints_units"], cfg["num_lstm_generation_units"],
                 cfg["linear_hidden_size"])
    n_md = len(cfg["metadata_values"])
    specs = [("note_embeddings.0.weight", (V + 1, E), "embedding")]
    c_in = D * n_md + E
    for k in range(cfg["num_layers"]):
        specs += _lstm_specs(f"lstm_constraint.{k}.", c_in if k == 0 else C, C)
    for k in range(cfg["num_layers"]):
        specs += _lstm_specs(f"lstm_generation.{k}.", E + C if k == 0 else G, G)
    specs += linear_specs("linear_1.", G, Lin) + linear_specs("linear_ouput_notes.0.", Lin, V)
    specs += [(f"metadata_embeddings.{i}.weight", (n, D), "embedding")
              for i, n in enumerate(cfg["metadata_values"])]
    return specs


def work(cfg: dict, requests: list) -> dict:
    """What ``requests`` need: (operations, bytes) of K7 (the recurrence at
    every tick, forced ones too, the head only at the span's ticks), the
    model's operations (K7's and the constraint stack's), the span
    measures."""
    V, E, D = cfg["vocab_size"], cfg["note_embedding_dim"], cfg["metadata_embedding_dim"]
    C, G, Lin = (cfg["num_lstm_constraints_units"], cfg["num_lstm_generation_units"],
                 cfg["linear_hidden_size"])
    k7 = moved = cons = measures = 0.0
    for r in requests:
        rows, m = len(r["tokens"]), r["tokens"].shape[1]
        ticks, span = m * TICKS_PER_MEASURE, r["num_measures"] * TICKS_PER_MEASURE
        k7 += (flops.arnn_ops(rows, ticks, G, C, 0, 0)
               + flops.arnn_ops(rows, span, 0, 0, Lin, V) + 2.0 * rows * span * G * Lin)
        moved += flops.arnn_bytes(rows, ticks, G, C, Lin, V, E)
        cons += flops.lstm_stack_ops(rows, ticks, D * len(cfg["metadata_values"]) + E, C,
                                     cfg["num_layers"])
        measures += rows * r["num_measures"]
    return {"k7": (k7, moved), "model_ops": k7 + cons, "measures": measures}


def _lstm_specs(prefix: str, inp: int, hidden: int) -> list:
    return [(prefix + "weight_ih_l0", (4 * hidden, inp), "matrix"),
            (prefix + "weight_hh_l0", (4 * hidden, hidden), "matrix"),
            (prefix + "bias_ih_l0", (4 * hidden,), "bias"),
            (prefix + "bias_hh_l0", (4 * hidden,), "bias")]


def metadata(ticks: int) -> np.ndarray:
    """(ticks, 3) beat marker, tick within the beat, voice id."""
    t = np.arange(ticks)
    marker = np.full(ticks, SLUR)
    marker[t % TICKS_PER_BEAT == 0] = BEAT
    marker[t % TICKS_PER_MEASURE == 0] = DOWNBEAT
    return np.stack([marker, t % TICKS_PER_BEAT, np.zeros(ticks, np.int64)], axis=1)


def _stack(w: dict, prefix: str, layers: int, xs: list, hidden: int, prec: Prec) -> list:
    """An LSTM stack over the list of per-tick inputs ``xs`` (in order)."""
    for k in range(layers):
        p = {n[len(f"{prefix}{k}."):]: v for n, v in w.items() if n.startswith(f"{prefix}{k}.")}
        h = c = xs[0].new_zeros((xs[0].shape[0], hidden))
        out = []
        for x in xs:
            h, c = lstm_step(p, x, h, c, prec)
            out.append(h)
        xs = out
    return xs


def span_logits(w: dict, cfg: dict, samples: list, prec: Prec):
    """Logits (B, T, V) over every tick of rows of one length, the served
    tokens (B, T) and the span mask (B, T)."""
    dev = w["linear_1.weight"].device
    V, C, G = cfg["vocab_size"], cfg["num_lstm_constraints_units"], cfg["num_lstm_generation_units"]
    layers = cfg["num_layers"]
    score = torch.from_numpy(np.stack([s["tokens"].reshape(-1) for s in samples])).to(dev).long()
    served = torch.from_numpy(np.stack([s["out"].reshape(-1) for s in samples])).to(dev).long()
    b, ticks = score.shape
    tick = torch.arange(ticks, device=dev)[None]
    lo = torch.tensor([s["start"] * TICKS_PER_MEASURE for s in samples], device=dev)[:, None]
    hi = torch.tensor([(s["start"] + s["num"]) * TICKS_PER_MEASURE for s in samples],
                      device=dev)[:, None]
    span = (tick >= lo) & (tick < hi)
    md = torch.from_numpy(metadata(ticks)).to(dev)
    emb = [w[f"metadata_embeddings.{i}.weight"][md[:, i]][None].expand(b, -1, -1)
           for i in range(md.shape[1])]
    notes = w["note_embeddings.0.weight"]
    emb.append(notes[torch.where(span, V, score)])
    cin = torch.cat(emb, dim=-1)
    rev = _stack(w, "lstm_constraint.", layers, [cin[:, t] for t in range(ticks - 1, -1, -1)],
                 C, prec)
    cons = rev[::-1]
    prev = [notes[cfg["start_index"]][None].expand(b, -1)] + [notes[served[:, t]]
                                                             for t in range(ticks - 1)]
    gen = _stack(w, "lstm_generation.", layers,
                 [torch.cat([p, c], dim=-1) for p, c in zip(prev, cons)], G, prec)
    out = torch.stack(gen, dim=1)
    hid = torch.relu(prec.linear(out, w["linear_1.weight"], w["linear_1.bias"]))
    logits = prec.linear(hid, w["linear_ouput_notes.0.weight"], w["linear_ouput_notes.0.bias"])
    return logits, served, span


def check(w: dict, cfg: dict, samples: list, control: bool = False) -> dict:
    """The compared numbers over the sampled rows (module docstring);
    ``control`` judges the float8 reference's first tokens instead of the
    served ones."""
    groups = {}
    for s in samples:
        groups.setdefault(s["tokens"].shape[0], []).append(s)
    widest, total, flips, tokens = 0.0, 0.0, 0, 0
    with exact_f32(), torch.no_grad():
        for group in groups.values():
            logits, served, span = span_logits(w, cfg, group, Prec("f32"))
            judged = served
            if control:
                judged = span_logits(w, cfg, group, Prec("fp8"))[0].argmax(dim=-1)
            g = gaps(logits, judged)[span]
            widest = max(widest, float(g.max()))
            total += float(g.sum())
            flips += int((g > 0).sum())
            tokens += g.numel()
    changed = 0
    for s in samples:
        keep = np.ones(s["tokens"].shape[0], bool)
        keep[s["start"]:s["start"] + s["num"]] = False
        changed += int((s["out"][keep] != s["tokens"][keep]).sum())
    return {"widest_gap": widest, "outside_span_changed": changed,
            "info": {"served_tokens": tokens, "mean_gap": total / max(tokens, 1),
                     "off_argmax_share": flips / max(tokens, 1)}}
