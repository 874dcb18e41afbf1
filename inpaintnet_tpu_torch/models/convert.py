"""Parameters between the JAX package, the reference ``state_dict`` layout
and the port's modules.

One table of leaves drives both directions. Each leaf is
``(path in the JAX params, state_dict key, transposed?)``: the JAX package
keeps (in, out) weights, the reference (and so the port's modules, whose
parameter names and shapes follow it) keeps torch's (out, in). The keys
are exactly what ``inpaintnet_tpu/models/torch_port.py export_latent_rnn``
and ``export_anticipation_rnn`` emit, so one checkpoint layout serves the
reference, the JAX package and the port.

- ``from_jax_params``: the JAX package's parameters (nested dicts and
  lists of numpy arrays) -> a ``state_dict`` for ``LatentRNN``;
  ``anticipation_rnn_from_jax_params`` the same for the AnticipationRNN,
  ``flat_decoder_from_jax_params`` for ``SRDecoder`` and
  ``SRDecoderNoInput`` (whose keys follow the reference's module names).
- ``to_functional``: a module's ``state_dict`` -> the nested (in, out)
  parameters the port's functional code (and its kernels) takes;
  ``from_functional`` is its inverse.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from inpaintnet_tpu_torch.models.base import nest_lists

Leaf = Tuple[tuple, str, bool]


def _linear(path: tuple, key: str) -> List[Leaf]:
    return [(path + ("w",), f"{key}.weight", True), (path + ("b",), f"{key}.bias", False)]


def _mlp_selu(path: tuple, key: str) -> List[Leaf]:
    # torch nn.Sequential(Linear, SELU, Linear): indices 0 and 2
    return _linear(path + ("l1",), f"{key}.0") + _linear(path + ("l2",), f"{key}.2")


def _gru(path: tuple, key: str, num_layers: int, num_dirs: int) -> List[Leaf]:
    leaves = []
    for layer in range(num_layers):
        for d in range(num_dirs):
            sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
            leaves += [
                (path + (layer, d, "w_ih"), f"{key}.weight_ih{sfx}", True),
                (path + (layer, d, "w_hh"), f"{key}.weight_hh{sfx}", True),
                (path + (layer, d, "b_ih"), f"{key}.bias_ih{sfx}", False),
                (path + (layer, d, "b_hh"), f"{key}.bias_hh{sfx}", False),
            ]
    return leaves


def measure_vae_leaves(enc_layers: int, dec_layers: int) -> List[Leaf]:
    e, d = ("encoder",), ("decoder",)
    return [
        (e + ("embedding", "table"), "encoder.note_embedding_layer.weight", False),
        *_gru(e + ("gru",), "encoder.lstm", enc_layers, 2),
        *_mlp_selu(e + ("mean_head",), "encoder.linear_mean"),
        *_mlp_selu(e + ("log_std_head",), "encoder.linear_log_std"),
        (d + ("embedding", "table"), "decoder.note_embedding_layer.weight", False),
        *_linear(d + ("z_to_beat_hidden",), "decoder.z_to_beat_rnn_input.0"),
        (d + ("b_0",), "decoder.b_0", False),
        *_gru(d + ("beat_gru",), "decoder.rnn_beat", dec_layers, 1),
        *_linear(d + ("beat_to_tick_hidden",), "decoder.beat_emb_to_tick_rnn_hidden.0"),
        *_linear(d + ("beat_to_tick_input",), "decoder.beat_emb_to_tick_rnn_input.0"),
        (d + ("x_0",), "decoder.x_0", False),
        *_gru(d + ("tick_gru",), "decoder.rnn_tick", dec_layers, 1),
        *_linear(d + ("head",), "decoder.tick_emb_to_note_emb.0"),
    ]


def flat_decoder_leaves(num_layers: int, no_input: bool = False) -> List[Leaf]:
    """``SRDecoder``'s leaves (``SRDecoderNoInput``'s with ``no_input``: its
    z projection is one linear layer, not the Linear/SELU/Linear stack)."""
    z_proj = (_linear(("z_to_rnn_input",), "z_to_rnn_input") if no_input
              else _mlp_selu(("z_to_rnn_input",), "z_to_rnn_input"))
    return [
        (("embedding", "table"), "note_embedding_layer.weight", False),
        *z_proj,
        (("x_0",), "x_0", False),
        *_gru(("gru",), "rnn_dec", num_layers, 1),
        *_linear(("head",), "rnn_out_to_note_emb.0"),
    ]


def latent_rnn_leaves(num_layers: int, auto_reg: bool = False) -> List[Leaf]:
    """A LatentRNN's own leaves (its frozen VAE sits under the
    ``vae_model.`` prefix). An autoregressive model has no ``x_0`` (its
    generation GRU reads z); the ablations have the same keys at other
    widths."""
    return [
        *_gru(("context_rnn_past",), "context_rnn_past", num_layers, 2),
        *_gru(("context_rnn_future",), "context_rnn_future", num_layers, 2),
        *_gru(("generation_rnn",), "generation_rnn", num_layers, 2),
        *_linear(("generation_linear",), "generation_linear"),
        *([] if auto_reg else [(("x_0",), "x_0", False)]),
    ]


def _lstm_list(path: tuple, key: str, num_layers: int) -> List[Leaf]:
    # the reference's per-layer one-layer nn.LSTM list: "{key}.{k}.weight_ih_l0"
    leaves = []
    for k in range(num_layers):
        leaves += [
            (path + (k, "w_ih"), f"{key}.{k}.weight_ih_l0", True),
            (path + (k, "w_hh"), f"{key}.{k}.weight_hh_l0", True),
            (path + (k, "b_ih"), f"{key}.{k}.bias_ih_l0", False),
            (path + (k, "b_hh"), f"{key}.{k}.bias_hh_l0", False),
        ]
    return leaves


def anticipation_rnn_leaves(num_layers: int, num_metadata: int) -> List[Leaf]:
    """The AnticipationRNN's leaves, keyed as ``export_anticipation_rnn``
    emits them (the reference's ``linear_ouput_notes`` [sic]);
    ``num_metadata`` counts the metadata channels with the voice id."""
    return [
        (("note_embedding", "table"), "note_embeddings.0.weight", False),
        *_lstm_list(("lstm_constraint",), "lstm_constraint", num_layers),
        *_lstm_list(("lstm_generation",), "lstm_generation", num_layers),
        *_linear(("linear_1",), "linear_1"),
        *_linear(("linear_output_notes",), "linear_ouput_notes.0"),
        *[(("metadata_embeddings", i, "table"), f"metadata_embeddings.{i}.weight", False)
          for i in range(num_metadata)],
    ]


def _get(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def _float32_state_dict(trees, leaves: List[Leaf]) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, key, transpose in leaves:
        a = np.asarray(_get(trees, path), dtype=np.float32)
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    return sd


def from_jax_params(vae_params_np: Mapping, latent_params_np: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MeasureVAE and LatentRNN parameters (numpy leaves)
    -> a float32 ``state_dict`` of the port's ``LatentRNN`` (or
    ``LatentRNNAblations``), keyed like ``export_latent_rnn(params,
    vae_params)``: autoregressive when the parameters hold no ``x_0``."""
    leaves = (
        [(("vae",) + p, f"vae_model.{k}", t)
         for p, k, t in measure_vae_leaves(len(vae_params_np["encoder"]["gru"]),
                                           len(vae_params_np["decoder"]["tick_gru"]))]
        + [(("latent",) + p, k, t)
           for p, k, t in latent_rnn_leaves(len(latent_params_np["context_rnn_past"]),
                                            auto_reg="x_0" not in latent_params_np)]
    )
    return _float32_state_dict({"vae": vae_params_np, "latent": latent_params_np}, leaves)


def anticipation_rnn_from_jax_params(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's AnticipationRNN parameters (numpy leaves) -> a
    float32 ``state_dict`` of the port's model, keyed like
    ``export_anticipation_rnn(params)``."""
    leaves = anticipation_rnn_leaves(len(params_np["lstm_constraint"]),
                                     len(params_np["metadata_embeddings"]))
    return _float32_state_dict(params_np, leaves)


def flat_decoder_from_jax_params(params_np: Mapping, no_input: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SRDecoder`` (``SRDecoderNoInput`` with
    ``no_input``) parameters (numpy leaves) -> a float32 ``state_dict`` of
    the port's."""
    return _float32_state_dict(params_np, flat_decoder_leaves(len(params_np["gru"]), no_input))


def to_functional(state_dict: Mapping[str, torch.Tensor], leaves: List[Leaf]):
    """A ``state_dict`` -> nested (in, out) parameters like the JAX
    package's pytree: dicts, with lists where the path holds an index.
    Every leaf must be present, and no other key."""
    missing = [k for _, k, _ in leaves if k not in state_dict]
    extra = set(state_dict) - {k for _, k, _ in leaves}
    if missing or extra:
        raise KeyError(f"state_dict does not match: missing {missing}, unexpected {sorted(extra)}")
    root: dict = {}
    for path, key, transpose in leaves:
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        t = state_dict[key].detach()
        node[path[-1]] = t.t().contiguous() if transpose else t
    return nest_lists(root)


def from_functional(params, leaves: List[Leaf]) -> Dict[str, torch.Tensor]:
    """Nested (in, out) parameters (tensors or numpy arrays) -> a
    ``state_dict`` keyed as ``leaves`` says, detached."""
    sd = {}
    for path, key, transpose in leaves:
        t = torch.as_tensor(_get(params, path)).detach()
        sd[key] = t.t() if transpose else t
    return sd
