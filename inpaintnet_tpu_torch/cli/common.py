"""Shared command-line plumbing of the port's entry points
(``inpaintnet_tpu/cli/common.py``).

The JAX package's root scripts are click commands; these are argparse
parsers with the same flag names, defaults and help. A click flag pair
such as ``--train/--test`` becomes two flags writing one destination with
the same default, and a bool option (``--has_metadata``) reads the words
click's BOOL reads. Every entry point has ``--device`` (default ``cuda``):
the models, trainers and testers run there, and ``cuda`` on a machine
without a usable card raises instead of running on the CPU.

Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE`` above 1) each rank of
a ``train_*`` entry point takes ``cuda:LOCAL_RANK`` and joins the process
group (NCCL; gloo with ``--device cpu``), and the trainers train
data-parallel over it (``train/trainer.py``); no flag changes.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from inpaintnet_tpu_torch.data import BeatMarkerMetadata, DatasetManager, TickMetadata

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def standard_datasets(dataset_name: str = "folk_4by4nbars_train", cache_dir=None,
                      corpus_dir=None, num_bars: int = 16):
    """The train and test ``FolkDatasetNBars`` every entry point builds
    (reference train_measure_vae.py:63-88)."""
    manager = DatasetManager(cache_dir=cache_dir, corpus_dir=corpus_dir)
    kwargs = {"metadatas": [BeatMarkerMetadata(subdivision=6), TickMetadata(subdivision=6)],
              "sequences_size": 32, "num_bars": num_bars}
    return (manager.get_dataset(dataset_name, train=True, **kwargs),
            manager.get_dataset(dataset_name, train=False, **kwargs))


def click_bool(value: str) -> bool:
    """A bool option's value as click's BOOL type reads it."""
    word = value.strip().lower()
    if word in _TRUE:
        return True
    if word in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"{value!r} is not a valid boolean")


def flag_pair(parser: argparse.ArgumentParser, on: str, off: str, default: bool,
              help: str = None) -> None:
    """Two flags, ``--on`` and ``--off``, setting one destination (``on``'s
    name), as click's ``--on/--off`` does."""
    parser.add_argument(f"--{on}", dest=on, action="store_true", default=default, help=help)
    parser.add_argument(f"--{off}", dest=on, action="store_false")


def add_options(parser: argparse.ArgumentParser, options, with_help: bool = True) -> None:
    """``(name, default, help)`` options whose type is their default's (an
    int, a float, a str or, read as click reads it, a bool)."""
    for name, default, help in options:
        kind = click_bool if isinstance(default, bool) else type(default)
        parser.add_argument(f"--{name}", type=kind, default=default,
                            help=help if with_help else None)


def dataset_options(parser: argparse.ArgumentParser) -> None:
    """Options pointing at the corpus and cache directories."""
    parser.add_argument("--dataset_name", default="folk_4by4nbars_train",
                        help="registry name of the dataset")
    parser.add_argument("--corpus_dir", default=None,
                        help="directory of tune_*.abc files (default $INPAINTNET_CORPUS_DIR)")
    parser.add_argument("--cache_dir", default=None, help="dataset cache directory")


def device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (default) or cpu")


def compute_dtype_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                        help="mixed-precision compute dtype (fp32 master params)")


def resolve_device(name: str) -> torch.device:
    """``--device``'s value as a device; a CUDA device that is not usable
    raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is false "
                         "(pass --device cpu to run on the CPU)")
    return device


def train_device(name: str) -> torch.device:
    """The trainers' ``--device``: :func:`resolve_device`, then under
    ``torchrun`` this rank's device with the process group joined
    (:func:`join_process_group`). Only the ``train_*`` entry points join:
    the others run one process's work."""
    return join_process_group(resolve_device(name))


def join_process_group(device: torch.device) -> torch.device:
    """With ``WORLD_SIZE`` above 1 (``torchrun`` sets it, with ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``): ``cuda:LOCAL_RANK``
    for a CUDA ``device``, and the process group initialised from those
    variables, NCCL on cards, gloo on the CPU. Else ``device`` as it is."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def trainer_dtype(compute_dtype):
    """``--compute_dtype`` as the trainers take it: None is f32."""
    return None if compute_dtype in (None, "float32") else compute_dtype


# --- the models' options, by the root scripts' names and defaults --------- #
def vae_options(has_metadata: bool):
    return [
        ("note_embedding_dim", 10, "size of the note embeddings"),
        ("metadata_embedding_dim", 2, "size of the metadata embeddings"),
        ("num_encoder_layers", 2, "number of layers in encoder RNN"),
        ("encoder_hidden_size", 512, "hidden size of the encoder RNN"),
        ("encoder_dropout_prob", 0.5, "dropout prob between encoder RNN layers"),
        ("has_metadata", has_metadata, "bool, True if data contains metadata"),
        ("latent_space_dim", 256, "dimension of latent space"),
        ("num_decoder_layers", 2, "number of layers in decoder RNN"),
        ("decoder_hidden_size", 512, "hidden size of the decoder RNN"),
        ("decoder_dropout_prob", 0.5, "dropout prob between decoder RNN layers"),
    ]


LATENT_RNN_OPTIONS = [
    ("num_latent_rnn_layers", 2, "number of layers in measure RNN"),
    ("latent_rnn_hidden_size", 512, "hidden size of the measure RNN"),
    ("latent_rnn_dropout_prob", 0.5, "dropout prob between measure RNN layers"),
]

ARNN_OPTIONS = [
    ("num_layers", 2, "number of layers of the LSTMs"),
    ("lstm_hidden_size", 256, "hidden size of the LSTMs"),
    ("dropout_lstm", 0.2, "dropout between LSTM layers"),
    ("input_dropout", 0.2, "input (timestep) dropout"),
    ("linear_hidden_size", 256, "hidden size of the Linear layers"),
]


def build_vae(args, dataset, device):
    """The MeasureVAE of the parsed options (``metadata_embedding_dim`` and
    ``has_metadata`` are read by neither package's model), its random
    parameters drawn from seed 0."""
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE

    return MeasureVAE(dataset, note_embedding_dim=args.note_embedding_dim,
                      num_encoder_layers=args.num_encoder_layers,
                      encoder_hidden_size=args.encoder_hidden_size,
                      encoder_dropout_prob=args.encoder_dropout_prob,
                      latent_space_dim=args.latent_space_dim,
                      num_decoder_layers=args.num_decoder_layers,
                      decoder_hidden_size=args.decoder_hidden_size,
                      decoder_dropout_prob=args.decoder_dropout_prob, device=device)


def build_latent_rnn(args, dataset, vae, device, *, auto_reg: bool,
                     teacher_forcing: bool = True, ablation=None):
    """The LatentRNN (or, with ``ablation`` "past" or "future", the
    ablation) of the parsed options over ``vae``."""
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN, LatentRNNAblations

    kw = dict(num_rnn_layers=args.num_latent_rnn_layers,
              rnn_hidden_size=args.latent_rnn_hidden_size, auto_reg=auto_reg, device=device,
              dataset=dataset, dropout=args.latent_rnn_dropout_prob,
              teacher_forcing=teacher_forcing)
    if ablation is None:
        return LatentRNN(vae, **kw)
    return LatentRNNAblations(vae, type=ablation, **kw)


def build_arnn(args, dataset, device, kind: str, teacher_forcing: bool = True):
    """The AnticipationRNN of the parsed options: ``kind`` "reg"
    (``ConstraintModelGaussianReg``) or "baseline"."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import (
        AnticipationRNNBaseline,
        ConstraintModelGaussianReg,
    )

    cls = ConstraintModelGaussianReg if kind == "reg" else AnticipationRNNBaseline
    return cls(dataset, note_embedding_dim=args.note_embedding_dim,
               metadata_embedding_dim=args.metadata_embedding_dim, num_layers=args.num_layers,
               num_lstm_constraints_units=args.lstm_hidden_size,
               num_lstm_generation_units=args.lstm_hidden_size,
               linear_hidden_size=args.linear_hidden_size, dropout_prob=args.dropout_lstm,
               dropout_input_prob=args.input_dropout, unary_constraint=True,
               teacher_forcing=teacher_forcing, device=device)
