"""Model presets (``inpaintnet_tpu/models/presets.py``)."""
from __future__ import annotations

import numpy as np
import torch

from inpaintnet_tpu_torch.models.convert import from_jax_params
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE


class VocabOnlyDataset:
    """Minimal dataset stand-in carrying just a vocabulary (the models
    read only ``note2index_dicts``) — for building models without a corpus."""

    def __init__(self, vocab_size: int = 60, name: str = "vocab-only"):
        names = [f"N{i}" for i in range(vocab_size - 4)] + ["START", "END", "__", "rest"]
        self.note2index_dicts = [{n: i for i, n in enumerate(names)}]
        self.name = name

    def __repr__(self):
        return f"VocabOnlyDataset({self.name},{len(self.note2index_dicts[0])})"


def build_latent_rnn(dataset, *, emb: int, hidden: int, z_dim: int, layers: int,
                     vae_params_np, latent_params_np, device="cuda",
                     dtype: torch.dtype = torch.float32):
    """A MeasureVAE + LatentRNN of the given geometry holding the given
    JAX-layout numpy parameters (random, or the JAX package's), on
    ``device`` in ``dtype``. The modules are made on the meta device, so no
    throwaway initialisation runs. Loading is strict.

    :return: (vae_model, latent_rnn_model)
    """
    vae = MeasureVAE(dataset, note_embedding_dim=emb, num_encoder_layers=layers,
                     encoder_hidden_size=hidden, latent_space_dim=z_dim,
                     num_decoder_layers=layers, decoder_hidden_size=hidden, device="meta")
    model = LatentRNN(vae, num_rnn_layers=2, rnn_hidden_size=hidden, device="meta")
    model.to_empty(device=device)
    model.load_state_dict(from_jax_params(vae_params_np, latent_params_np), strict=True)
    model.to(dtype)
    return vae, model


def build_flagship(vocab_size: int = 60, hidden: int = 512, z_dim: int = 256, emb: int = 10,
                   layers: int = 2, seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32, dataset=None):
    """Full-size MeasureVAE + LatentRNN (the shipped reference config) with
    random weights drawn from ``numpy.random.default_rng(seed)``.

    :return: (dataset, vae_model, latent_rnn_model)
    """
    ds = dataset if dataset is not None else VocabOnlyDataset(vocab_size)
    rng = np.random.default_rng(seed)
    template = MeasureVAE(ds, note_embedding_dim=emb, num_encoder_layers=layers,
                          encoder_hidden_size=hidden, latent_space_dim=z_dim,
                          num_decoder_layers=layers, decoder_hidden_size=hidden,
                          device="meta")
    vae_np = template.init_params(rng)
    latent_np = LatentRNN(template, num_rnn_layers=2, rnn_hidden_size=hidden,
                          device="meta").init_params(rng)
    vae, model = build_latent_rnn(ds, emb=emb, hidden=hidden, z_dim=z_dim, layers=layers,
                                  vae_params_np=vae_np, latent_params_np=latent_np,
                                  device=device, dtype=dtype)
    return ds, vae, model
