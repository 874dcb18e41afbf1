"""Train or evaluate the MeasureVAE (``train_measure_vae.py``; reference
train_measure_vae.py:12-131, the same flags and ``--device``).

    python -m inpaintnet_tpu_torch.cli.train_measure_vae [--device cpu] ...
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli.common import (
    add_options,
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_options(parser, vae_options(has_metadata=False) + [
        ("batch_size", 256, "training batch size"),
        ("num_epochs", 30, "number of training epochs"),
    ])
    flag_pair(parser, "train", "test", True, "train or evaluate the model")
    flag_pair(parser, "plot", "no_plot", False, "plot the training log")
    flag_pair(parser, "log", "no_log", True, "log epoch metrics")
    add_options(parser, [("lr", 1e-4, "learning rate")])
    compute_dtype_option(parser)
    dataset_options(parser)
    device_option(parser)
    return parser


def main(argv=None):
    """-> (test loss, test accuracy)"""
    from inpaintnet_tpu_torch.eval import VAETester
    from inpaintnet_tpu_torch.train import VAETrainer

    args = build_parser().parse_args(argv)
    device = train_device(args.device)
    folk_dataset, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    model = build_vae(args, folk_dataset, device)
    if args.train:
        trainer = VAETrainer(folk_dataset, model, lr=args.lr,
                             compute_dtype=trainer_dtype(args.compute_dtype), device=device)
        trainer.train_model(batch_size=args.batch_size, num_epochs=args.num_epochs,
                            plot=args.plot, log=args.log)
    else:
        model.load()
    return VAETester(folk_dataset_test, model).test_model()


if __name__ == "__main__":
    main()
