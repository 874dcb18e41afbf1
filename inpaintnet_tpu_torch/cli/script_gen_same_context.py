"""Diversity demo (``script_gen_same_context.py``; reference
script_gen_same_context.py:15-214, the same flags and ``--device``): N
stochastic re-inpaintings of one fixed tune with the same past and future,
written as MIDI and ABC.

    python -m inpaintnet_tpu_torch.cli.script_gen_same_context [--device cpu] ...
"""
from __future__ import annotations

import argparse
import os

from inpaintnet_tpu_torch.cli.common import (
    LATENT_RNN_OPTIONS,
    add_options,
    build_latent_rnn,
    build_vae,
    dataset_options,
    device_option,
    resolve_device,
    standard_datasets,
    vae_options,
)

NUM_PAST, NUM_TARGET, NUM_FUTURE = 6, 4, 6
REQ_LENGTH = 16 * 4 * 6  # 16 measures of 24 ticks


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_options(parser, vae_options(has_metadata=True) + LATENT_RNN_OPTIONS, with_help=False)
    add_options(parser, [("tune_id", "tune_16154",
                          "filename stem of the fixed tune (reference :185)"),
                         ("num_generations", 15, None), ("save_folder", "saved_midi", None)])
    dataset_options(parser)
    device_option(parser)
    return parser


def usable_tune(dataset, tune_id: str):
    """``tune_id``'s score tensor (or, where the test split lacks it, the
    split's first tune's), cut to 16 measures. -> (tune id, (1, 384))"""
    fname = tune_id + ".abc"
    if fname not in dataset.dataset_filenames:
        fname = dataset.dataset_filenames[0]
        tune_id = fname[:-4]
    score = dataset.corpus_it_gen.get_score_from_path(
        os.path.join(dataset.corpus_it_gen.raw_dir, fname), fix_and_expand=True)
    st = dataset.get_score_tensor(score)
    if st.shape[1] < REQ_LENGTH:
        raise SystemExit(f"{tune_id} is shorter than 16 measures")
    return tune_id, st[:, :REQ_LENGTH]


def main(argv=None) -> list:
    """-> the paths of the MIDI files written"""
    from inpaintnet_tpu_torch.data.abc_writer import write_abc
    from inpaintnet_tpu_torch.data.midi import write_midi
    from inpaintnet_tpu_torch.eval import LatentRNNTester
    from inpaintnet_tpu_torch.train.latent_rnn_trainer import split_score

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    folk_dataset_train, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    os.makedirs(args.save_folder, exist_ok=True)
    vae_model = build_vae(args, folk_dataset_train, device).load()
    model = build_latent_rnn(args, folk_dataset_train, vae_model, device, auto_reg=False).load()
    tune_id, st = usable_tune(folk_dataset_test, args.tune_id)
    past, future, target = split_score(st[:, None, :], NUM_PAST, NUM_FUTURE, NUM_TARGET, 24)
    written = []
    # the randomness is the frozen encoder's rsample, drawn by seed
    for j in range(args.num_generations):
        tester = LatentRNNTester(folk_dataset_test, model, seed=j)
        gen_score, _, _ = tester.generate(past, future, target, NUM_TARGET)
        stem = os.path.join(args.save_folder, f"{tune_id}_{j}_latent_rnn")
        write_midi(gen_score, stem + ".mid")
        with open(stem + ".abc", "w") as fh:
            fh.write(write_abc(gen_score, title=f"{tune_id} regen {j}"))
        written.append(stem + ".mid")
    print(f"wrote {args.num_generations} re-inpaintings of {tune_id} to {args.save_folder}/")
    return written


if __name__ == "__main__":
    main()
