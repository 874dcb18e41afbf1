"""Train or evaluate the LatentRNN (InpaintNet) over a trained MeasureVAE
(``train_inpaintnet.py``; reference train_inpaintnet.py:14-190, the same
flags and ``--device``).

    python -m inpaintnet_tpu_torch.cli.train_inpaintnet [--device cpu] ...
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli.common import (
    LATENT_RNN_OPTIONS,
    add_options,
    build_latent_rnn,
    build_vae,
    compute_dtype_option,
    dataset_options,
    device_option,
    flag_pair,
    standard_datasets,
    train_device,
    trainer_dtype,
    vae_options,
)


def add_latent_training_options(parser: argparse.ArgumentParser, num_epochs: int,
                                plot: bool, early_stop: bool) -> None:
    """The options ``train_inpaintnet.py`` and its ablation share, at the
    script's defaults."""
    add_options(parser, vae_options(has_metadata=True) + LATENT_RNN_OPTIONS + [
        ("batch_size", 32, "training batch size"),
        ("num_epochs", num_epochs, "number of training epochs"),
    ])
    flag_pair(parser, "train", "test", True, "train or evaluate the model")
    add_options(parser, [("lr", 1e-4, "learning rate")])
    flag_pair(parser, "plot", "no_plot", plot, "plot the training log")
    flag_pair(parser, "log", "no_log", True, "log epoch metrics")
    flag_pair(parser, "auto_reg", "no_auto_reg", True, "auto-regressive generation RNN")
    flag_pair(parser, "teacher_forcing", "no_teacher_forcing", True, "use teacher forcing")
    flag_pair(parser, "early_stop", "no_early_stop", early_stop, "use early stopping")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_latent_training_options(parser, num_epochs=100, plot=False, early_stop=False)
    compute_dtype_option(parser)
    dataset_options(parser)
    device_option(parser)
    return parser


def run(args, ablation=None):
    """Train (or load, with ``--test``) the model of the parsed options
    over the trained VAE, then test it. -> (test loss, test accuracy)"""
    from inpaintnet_tpu_torch.eval import LatentRNNTester
    from inpaintnet_tpu_torch.train import LatentRNNTrainer

    device = train_device(args.device)
    folk_dataset_train, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    vae_model = build_vae(args, folk_dataset_train, device).load()  # trained beforehand
    model = build_latent_rnn(args, folk_dataset_train, vae_model, device,
                             auto_reg=args.auto_reg, teacher_forcing=args.teacher_forcing,
                             ablation=ablation)
    if args.train:
        trainer = LatentRNNTrainer(folk_dataset_train, model, lr=args.lr,
                                   early_stopping=args.early_stop,
                                   compute_dtype=trainer_dtype(args.compute_dtype),
                                   device=device)
        trainer.train_model(batch_size=args.batch_size, num_epochs=args.num_epochs,
                            plot=args.plot, log=args.log)
    else:
        model.load()
    return LatentRNNTester(folk_dataset_test, model).test_model(batch_size=args.batch_size)


def main(argv=None):
    """-> (test loss, test accuracy)"""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
