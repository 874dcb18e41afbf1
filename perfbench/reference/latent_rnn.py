"""Plain reference of InpaintNet's inference (Pati, Lerch and Hadjeres,
ISMIR 2019; the parameter names and shapes of its PyTorch code): a frozen
MeasureVAE and a non-autoregressive LatentRNN, in float32.

For one served request row (its input tune, its span, its seed and its
row within the request) and the tokens the program returned for the span:

1. each present measure (the past ones before the span, the future ones
   after it) goes through the MeasureVAE encoder: note embedding, a
   2-layer bidirectional GRU over its 24 ticks, the final hiddens of every
   layer and direction concatenated, and Linear/SELU/Linear mean and
   log-std heads; z = mean + std * noise, the noise worked out again from
   the request's seed (``noise.py``: slot s of the 16 past and 16 future
   slots takes elements s*z .. s*z + z - 1 of the row's normals);
2. the past and the future z sequences (padding dropped) each go through
   a 2-layer bidirectional context GRU from zero; the final hiddens of
   both, concatenated on the feature axis, start the generation GRU
   (2 layers, bidirectional, hidden 2H), which runs over the span's
   measures on the learned constant input x_0; a linear map takes its
   outputs to one z a target measure;
3. the hierarchical decoder decodes each target z teacher-forced on the
   served tokens: z -> SELU(Linear) -> the beat GRU's hiddens, 4 beat
   steps on the constant b_0, per beat SELU(Linear) maps to the tick GRU's
   hiddens and to its beat context; each of the 24 ticks feeds
   [embedding of the previous served token (x_0 at tick 0), beat context]
   to the 2-layer tick GRU, whose hiddens restart at every beat, and
   ReLU(Linear) gives the logits.

The compared numbers: the widest gap by which a served token's logit lies
below the reference's best at its position, and the count of tokens
outside the span that differ from the input.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import flops
from perfbench.reference import noise
from perfbench.reference.common import (Prec, exact_f32, gaps, gru_specs, gru_stack,
                                        linear_specs, sub)

TICKS = 24
BEATS = 4


def param_specs(cfg: dict) -> list:
    """(name, shape, kind) of every parameter, under the published model's
    ``state_dict`` names (the LatentRNN's own, then ``vae_model.*``)."""
    V, E, Z = cfg["vocab_size"], cfg["note_embedding_dim"], cfg["latent_space_dim"]
    He, Le = cfg["encoder_hidden_size"], cfg["num_encoder_layers"]
    Hd, Ld = cfg["decoder_hidden_size"], cfg["num_decoder_layers"]
    H, L = cfg["latent_rnn_hidden_size"], cfg["num_latent_rnn_layers"]
    enc, dec = "vae_model.encoder.", "vae_model.decoder."
    return ([("x_0", (1, 1, 1), "normal"),
             (enc + "note_embedding_layer.weight", (V, E), "embedding")]
            + gru_specs(enc + "lstm.", E, He, Le, True)
            + linear_specs(enc + "linear_mean.0.", 2 * Le * He, 2 * He)
            + linear_specs(enc + "linear_mean.2.", 2 * He, Z)
            + linear_specs(enc + "linear_log_std.0.", 2 * Le * He, 2 * He)
            + linear_specs(enc + "linear_log_std.2.", 2 * He, Z)
            + [(dec + "b_0", (1,), "normal"), (dec + "x_0", (E,), "normal"),
               (dec + "note_embedding_layer.weight", (V, E), "embedding")]
            + linear_specs(dec + "z_to_beat_rnn_input.0.", Z, Hd * Ld)
            + gru_specs(dec + "rnn_beat.", 1, Hd, Ld, False)
            + linear_specs(dec + "beat_emb_to_tick_rnn_hidden.0.", Hd, Hd * Ld)
            + linear_specs(dec + "beat_emb_to_tick_rnn_input.0.", Hd, Hd)
            + gru_specs(dec + "rnn_tick.", E + Hd, Hd, Ld, False)
            + linear_specs(dec + "tick_emb_to_note_emb.0.", Hd, V)
            + gru_specs("context_rnn_past.", Z, H, L, True)
            + gru_specs("context_rnn_future.", Z, H, L, True)
            + gru_specs("generation_rnn.", 1, H * L, L, True)
            + linear_specs("generation_linear.", 2 * H * L, Z))


def work(cfg: dict, requests: list) -> dict:
    """What ``requests`` need of each kernel and of the model: (operations,
    bytes) of K1 over the measures present (past and future, padding
    left out) and of K2 over the target measures asked for; the model's
    operations (encoder and heads, both context GRUs over their present
    steps, the generation GRU and linear over the span, the decode); the
    target measures."""
    V, E, Z = cfg["vocab_size"], cfg["note_embedding_dim"], cfg["latent_space_dim"]
    He, Hd = cfg["encoder_hidden_size"], cfg["decoder_hidden_size"]
    H, L = cfg["latent_rnn_hidden_size"], cfg["num_latent_rnn_layers"]
    enc = target = ops = 0.0
    for r in requests:
        rows, m = len(r["tokens"]), r["tokens"].shape[1]
        start, num = r["start_measure"], r["num_measures"]
        future = m - start - num
        enc += rows * (start + future)
        target += rows * num
        ops += (flops.gru_stack_ops(rows, start, Z, H, L, 2)
                + flops.gru_stack_ops(rows, future, Z, H, L, 2)
                + flops.gru_stack_ops(rows, num, 1, H * L, L, 2)
                + 2.0 * rows * num * 2 * H * L * Z)
    ops += (flops.encoder_ops(enc, TICKS, He) + flops.encoder_heads_ops(enc, He, Z)
            + flops.decode_ops(target, Hd, V) + flops.decoder_prelude_ops(target, Hd, Z))
    return {"k1": (flops.encoder_ops(enc, TICKS, He), flops.encoder_bytes(enc, TICKS, He, E, V)),
            "k2": (flops.decode_ops(target, Hd, V), flops.decode_bytes(target, Hd, V, E)),
            "model_ops": ops, "measures": target}


def _mlp(w: dict, prefix: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    h = torch.selu(prec.linear(x, w[prefix + "0.weight"], w[prefix + "0.bias"]))
    return prec.linear(h, w[prefix + "2.weight"], w[prefix + "2.bias"])


def encode(w: dict, cfg: dict, tokens: torch.Tensor, prec: Prec):
    """(N, 24) tokens -> (mean, std), (N, z) each."""
    enc = sub(w, "vae_model.encoder.")
    He, Le = cfg["encoder_hidden_size"], cfg["num_encoder_layers"]
    x = enc["note_embedding_layer.weight"][tokens.long()]
    h0 = [x.new_zeros((x.shape[0], He))] * (2 * Le)
    _, finals = gru_stack(sub(enc, "lstm."), x, h0, Le, True, prec)
    hidden = torch.cat(finals, dim=-1)
    return _mlp(enc, "linear_mean.", hidden, prec), torch.exp(_mlp(enc, "linear_log_std.",
                                                                  hidden, prec))


def decode_forced(w: dict, cfg: dict, z: torch.Tensor, served: torch.Tensor,
                  prec: Prec) -> torch.Tensor:
    """Logits (N, 24, V) of the decoder on z (N, Z), teacher-forced on the
    served tokens (N, 24)."""
    dec = sub(w, "vae_model.decoder.")
    Hd, Ld = cfg["decoder_hidden_size"], cfg["num_decoder_layers"]
    n = z.shape[0]
    h_beat = torch.selu(prec.linear(z, dec["z_to_beat_rnn_input.0.weight"],
                                    dec["z_to_beat_rnn_input.0.bias"]))
    h0 = [h_beat[:, k * Hd:(k + 1) * Hd] for k in range(Ld)]
    beat_in = dec["b_0"].reshape(1, 1, 1).expand(n, BEATS, 1)
    beat_out, _ = gru_stack(sub(dec, "rnn_beat."), beat_in, h0, Ld, False, prec)
    tick_h = torch.selu(prec.linear(beat_out, dec["beat_emb_to_tick_rnn_hidden.0.weight"],
                                    dec["beat_emb_to_tick_rnn_hidden.0.bias"]))
    tick_ctx = torch.selu(prec.linear(beat_out, dec["beat_emb_to_tick_rnn_input.0.weight"],
                                      dec["beat_emb_to_tick_rnn_input.0.bias"]))
    table = dec["note_embedding_layer.weight"]
    prev = torch.cat([dec["x_0"].expand(n, 1, -1), table[served[:, :-1].long()]], dim=1)
    tick = sub(dec, "rnn_tick.")
    per_beat = TICKS // BEATS
    logits = []
    for beat in range(BEATS):
        xs = torch.cat([prev[:, beat * per_beat:(beat + 1) * per_beat],
                        tick_ctx[:, beat:beat + 1].expand(n, per_beat, Hd)], dim=-1)
        h0 = [tick_h[:, beat, k * Hd:(k + 1) * Hd] for k in range(Ld)]
        out, _ = gru_stack(tick, xs, h0, Ld, False, prec)
        logits.append(torch.relu(prec.linear(out, dec["tick_emb_to_note_emb.0.weight"],
                                              dec["tick_emb_to_note_emb.0.bias"])))
    return torch.cat(logits, dim=1)


def _context(w: dict, which: str, z: torch.Tensor, cfg: dict, prec: Prec) -> list:
    """Final hiddens of a context GRU over z (B, n, Z); zeros when n is 0."""
    H, L = cfg["latent_rnn_hidden_size"], cfg["num_latent_rnn_layers"]
    h0 = [z.new_zeros((z.shape[0], H))] * (2 * L)
    if z.shape[1] == 0:
        return h0
    return gru_stack(sub(w, f"context_rnn_{which}."), z, h0, L, True, prec)[1]


def span_logits(w: dict, cfg: dict, group: list, prec: Prec) -> torch.Tensor:
    """Reference logits (B, num, 24, V) of the span of rows that share a
    length, start and span length; ``group`` items are the check's samples
    (``tokens`` (M, 24), ``start``, ``num``, ``seed``, ``row``, ``out``)."""
    dev = w["x_0"].device
    Z, n_bars = cfg["latent_space_dim"], cfg["n_bars"]
    m, start, num = group[0]["tokens"].shape[0], group[0]["start"], group[0]["num"]
    n_future = m - start - num
    tokens = torch.from_numpy(np.stack([s["tokens"] for s in group])).to(dev)
    keys = np.concatenate([noise.row_keys(s["seed"], s["row"] + 1)[-1:] for s in group])
    eps = noise.row_normal(keys, 2 * n_bars * Z, dev).reshape(len(group), 2 * n_bars, Z)
    present = torch.cat([tokens[:, :start], tokens[:, m - n_future:]], dim=1)
    mean, std = encode(w, cfg, present.reshape(-1, TICKS), prec)
    z = (mean + std * torch.cat([eps[:, :start], eps[:, n_bars:n_bars + n_future]],
                                dim=1).reshape(-1, Z)).reshape(len(group), -1, Z)
    ctx_p = _context(w, "past", z[:, :start], cfg, prec)
    ctx_f = _context(w, "future", z[:, start:], cfg, prec)
    h0 = [torch.cat([p, f], dim=-1) for p, f in zip(ctx_p, ctx_f)]
    L = cfg["num_latent_rnn_layers"]
    x = w["x_0"].reshape(1, 1, 1).expand(len(group), num, 1)
    gen, _ = gru_stack(sub(w, "generation_rnn."), x, h0, L, True, prec)
    z_out = prec.linear(gen, w["generation_linear.weight"], w["generation_linear.bias"])
    served = torch.from_numpy(np.stack([s["out"][start:start + num] for s in group])).to(dev)
    logits = decode_forced(w, cfg, z_out.reshape(-1, Z), served.reshape(-1, TICKS), prec)
    return logits.reshape(len(group), num, TICKS, -1), served


def check(w: dict, cfg: dict, samples: list) -> dict:
    """The compared numbers over the sampled rows (see the module
    docstring), and how many served tokens they cover."""
    groups = {}
    for s in samples:
        groups.setdefault((s["tokens"].shape[0], s["start"], s["num"]), []).append(s)
    widest, total, flips, tokens = 0.0, 0.0, 0, 0
    with exact_f32(), torch.no_grad():
        for group in groups.values():
            logits, served = span_logits(w, cfg, group, Prec("f32"))
            g = gaps(logits, served)
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
