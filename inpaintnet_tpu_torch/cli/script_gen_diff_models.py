"""Listening-test generator (``script_gen_diff_models.py``; reference
script_gen_diff_models.py:17-356, the same flags and ``--device``): for
test tunes of at least 16 measures, the original and the LatentRNN's,
ARNN-reg's and ARNN-baseline's inpaintings (past 6, target 4, future 6
measures) as MIDI files, the original and the LatentRNN's also as ABC.

    python -m inpaintnet_tpu_torch.cli.script_gen_diff_models [--device cpu] ...
"""
from __future__ import annotations

import argparse
import os

from inpaintnet_tpu_torch.cli.common import (
    ARNN_OPTIONS,
    LATENT_RNN_OPTIONS,
    add_options,
    build_arnn,
    build_latent_rnn,
    build_vae,
    dataset_options,
    device_option,
    resolve_device,
    standard_datasets,
    vae_options,
)
from inpaintnet_tpu_torch.cli.script_gen_same_context import (
    NUM_FUTURE,
    NUM_PAST,
    NUM_TARGET,
    REQ_LENGTH,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_options(parser, vae_options(has_metadata=True) + LATENT_RNN_OPTIONS + ARNN_OPTIONS + [
        ("batch_size", 16, None), ("num_target", 2, None), ("num_models", 4, None),
        ("num_melodies", 32, None), ("save_folder", "saved_midi", None)], with_help=False)
    dataset_options(parser)
    device_option(parser)
    return parser


def main(argv=None) -> list:
    """-> the paths of the MIDI files written"""
    from inpaintnet_tpu_torch.data.abc_writer import write_abc
    from inpaintnet_tpu_torch.data.midi import write_midi
    from inpaintnet_tpu_torch.eval import AnticipationRNNTester, LatentRNNTester
    from inpaintnet_tpu_torch.train.latent_rnn_trainer import split_score

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    folk_dataset_train, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    save = args.save_folder
    os.makedirs(save, exist_ok=True)
    vae_model = build_vae(args, folk_dataset_train, device).load()
    written = []

    def write(score, stem: str, title=None):
        write_midi(score, os.path.join(save, stem + ".mid"))
        written.append(os.path.join(save, stem + ".mid"))
        if title is not None:
            with open(os.path.join(save, stem + ".abc"), "w") as fh:
                fh.write(write_abc(score, title=title))

    # the originals
    corpus = folk_dataset_test.corpus_it_gen
    usable = []
    for f in folk_dataset_test.dataset_filenames[:args.num_melodies]:
        score = corpus.get_score_from_path(os.path.join(corpus.raw_dir, f), fix_and_expand=True)
        st = folk_dataset_test.get_score_tensor(score)
        if st.shape[1] < REQ_LENGTH:
            continue
        st = st[:, :REQ_LENGTH]
        md = folk_dataset_test.get_metadata_tensor(score)[:REQ_LENGTH]
        usable.append((f[:-4], st, md))
        write(folk_dataset_test.tensor_to_score(st), f"{f[:-4]}_original", f"{f[:-4]} original")

    # the LatentRNN's inpaintings (the shipped config: not autoregressive)
    latent_rnn_model = build_latent_rnn(args, folk_dataset_train, vae_model, device,
                                        auto_reg=False).load()
    latent_rnn_tester = LatentRNNTester(folk_dataset_test, latent_rnn_model)
    for f_id, st, _ in usable:
        past, future, target = split_score(st[:, None, :], NUM_PAST, NUM_FUTURE, NUM_TARGET, 24)
        gen_score, _, _ = latent_rnn_tester.generate(past, future, target, NUM_TARGET)
        write(gen_score, f"{f_id}_latent_rnn", f"{f_id} latent_rnn")

    # both ARNNs' inpaintings, sampled at temperature 1.5
    for kind, suffix in (("reg", "arnn_reg"), ("baseline", "arnn_baseline")):
        tester = AnticipationRNNTester(folk_dataset_test,
                                       build_arnn(args, folk_dataset_train, device, kind).load())
        for f_id, st, md in usable:
            gen_score, _, _ = tester.generation(tensor_score=st, tensor_metadata=md,
                                                start_measure=NUM_PAST,
                                                num_measures_gen=NUM_TARGET, temperature=1.5)
            write(gen_score, f"{f_id}_{suffix}")
    print(f"wrote {4 * len(usable)} MIDI files to {save}/")
    return written


if __name__ == "__main__":
    main()
