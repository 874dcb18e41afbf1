"""Model presets (``inpaintnet_tpu/models/presets.py``)."""
from __future__ import annotations

import numpy as np
import torch

from inpaintnet_tpu_torch.data.metadata import BeatMarkerMetadata, TickMetadata
from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
from inpaintnet_tpu_torch.models.convert import from_jax_params
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN, LatentRNNAblations
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


class ARNNDataset(VocabOnlyDataset):
    """A vocabulary and the metadata channels of the folk datasets (beat
    marker and tick, plus the voice id the model appends), for building an
    AnticipationRNN without a corpus; 4/4 measures of 6-tick beats."""

    def __init__(self, vocab_size: int = 60, name: str = "arnn"):
        super().__init__(vocab_size, name)
        self.metadatas = [BeatMarkerMetadata(), TickMetadata()]
        self.num_voices = 1
        self.subdivision = 6
        self.num_beats_per_bar = 4


def _latent_rnn(vae, hidden: int, auto_reg: bool, ablation, device, dropout: float):
    """A LatentRNN (2 layers), or with ``ablation`` ("past" or "future") a
    ``LatentRNNAblations`` of that type."""
    if ablation is None:
        return LatentRNN(vae, num_rnn_layers=2, rnn_hidden_size=hidden, auto_reg=auto_reg,
                         device=device, dropout=dropout)
    return LatentRNNAblations(vae, num_rnn_layers=2, rnn_hidden_size=hidden,
                              auto_reg=auto_reg, device=device, type=ablation, dropout=dropout)


def build_latent_rnn(dataset, *, emb: int, hidden: int, z_dim: int, layers: int,
                     vae_params_np, latent_params_np, auto_reg: bool = False,
                     ablation=None, device="cuda", dtype: torch.dtype = torch.float32,
                     dropout: float = 0.5, latent_hidden=None):
    """A MeasureVAE + LatentRNN of the given geometry holding the given
    JAX-layout numpy parameters (random, or the JAX package's), on
    ``device`` in ``dtype``: autoregressive with ``auto_reg``, the past-only
    or future-only ablation with ``ablation="past"|"future"``; ``dropout``
    is the LatentRNN's in training (``train_inpaintnet.py``'s default);
    ``latent_hidden`` the LatentRNN's hidden size where it is not the VAE's
    ``hidden`` (``train_inpaintnet.py --latent_rnn_hidden_size``). The
    modules are made on the meta device, so no throwaway initialisation
    runs. Loading is strict.

    :return: (vae_model, latent_rnn_model)
    """
    vae = MeasureVAE(dataset, note_embedding_dim=emb, num_encoder_layers=layers,
                     encoder_hidden_size=hidden, latent_space_dim=z_dim,
                     num_decoder_layers=layers, decoder_hidden_size=hidden, device="meta")
    model = _latent_rnn(vae, latent_hidden or hidden, auto_reg, ablation, "meta", dropout)
    model.to_empty(device=device)
    model.load_state_dict(from_jax_params(vae_params_np, latent_params_np), strict=True)
    model.to(dtype)
    return vae, model


def build_flagship(vocab_size: int = 60, hidden: int = 512, z_dim: int = 256, emb: int = 10,
                   layers: int = 2, seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32, dataset=None, auto_reg: bool = False,
                   ablation=None, dropout: float = 0.5, latent_hidden=None):
    """Full-size MeasureVAE + LatentRNN (the shipped reference config; with
    ``auto_reg`` its autoregressive mode, with ``ablation`` the past-only or
    future-only model) with random weights drawn from
    ``numpy.random.default_rng(seed)``; ``dropout`` is the LatentRNN's in
    training; ``latent_hidden`` the LatentRNN's hidden size where it is not
    the VAE's ``hidden`` (768: ``train_inpaintnet.py --latent_rnn_hidden_size
    768``, whose generation GRU is 1,536 wide). Every dropout of the VAE is
    its default, 0.5.

    :return: (dataset, vae_model, latent_rnn_model)
    """
    ds = dataset if dataset is not None else VocabOnlyDataset(vocab_size)
    rng = np.random.default_rng(seed)
    template = MeasureVAE(ds, note_embedding_dim=emb, num_encoder_layers=layers,
                          encoder_hidden_size=hidden, latent_space_dim=z_dim,
                          num_decoder_layers=layers, decoder_hidden_size=hidden,
                          device="meta")
    vae_np = template.init_params(rng)
    latent_np = _latent_rnn(template, latent_hidden or hidden, auto_reg, ablation, "meta",
                            dropout).init_params(rng)
    vae, model = build_latent_rnn(ds, emb=emb, hidden=hidden, z_dim=z_dim, layers=layers,
                                  vae_params_np=vae_np, latent_params_np=latent_np,
                                  auto_reg=auto_reg, ablation=ablation, device=device,
                                  dtype=dtype, dropout=dropout, latent_hidden=latent_hidden)
    return ds, vae, model


def build_arnn(small: bool = False, seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.float32):
    """The flagship AnticipationRNN (``benchmarks/common_arnn.py``,
    ``train_arnn_baseline.py``): ``AnticipationRNNBaseline``, note embedding
    10, metadata embedding 2, unary constraints, 2-layer constraint and
    generation LSTMs of 256 units, linear hidden 256, vocab 60; or 2 x 16 with
    ``small`` (CPU tests). Random weights from
    ``numpy.random.default_rng(seed)``, on ``device`` in ``dtype``; its
    ``dataset`` is an :class:`ARNNDataset`."""
    h = 16 if small else 256
    model = AnticipationRNNBaseline(
        ARNNDataset(), note_embedding_dim=10, metadata_embedding_dim=2,
        num_lstm_constraints_units=h, num_lstm_generation_units=h, linear_hidden_size=h,
        num_layers=2, unary_constraint=True, device=device, seed=seed)
    return model.to(dtype)
