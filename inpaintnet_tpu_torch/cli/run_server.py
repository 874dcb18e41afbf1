"""Serve trained InpaintNet checkpoints over HTTP (``run_server.py``, the same
flags and ``--device``): loads the MeasureVAE and LatentRNN checkpoints
the training entry points wrote (the same config-addressed flags) into an
``InpaintingEngine`` behind ``inpaintnet_tpu_torch.server.InpaintingServer``;
``--serve_arnn`` also loads an AnticipationRNN checkpoint into an
``ARNNServingEngine`` at ``POST /v1/arnn/inpaint``.

    python -m inpaintnet_tpu_torch.cli.run_server --port 8080 --serve_dtype int8 \\
        --warmup --batching --serve_arnn baseline
    curl -s localhost:8080/v1/meta
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli.common import (
    LATENT_RNN_OPTIONS,
    add_options,
    build_arnn,
    build_latent_rnn,
    build_vae,
    dataset_options,
    device_option,
    flag_pair,
    resolve_device,
    standard_datasets,
    vae_options,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_options(parser, vae_options(has_metadata=True) + LATENT_RNN_OPTIONS, with_help=False)
    flag_pair(parser, "auto_reg", "no_auto_reg", False)
    add_options(parser, [("host", "127.0.0.1", None), ("port", 8000, None)])
    parser.add_argument("--serve_dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "int8"])
    parser.add_argument("--batch_buckets", default="1,8,64,512",
                        help="comma-separated engine batch buckets")
    flag_pair(parser, "warmup", "no_warmup", False,
              "pre-compile every bucket before accepting traffic")
    flag_pair(parser, "batching", "no_batching", False,
              "coalesce concurrent inpaint requests into one device batch "
              "(non-autoregressive engines only; a response never depends on which "
              "requests share its batch)")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="batching: how long the first request of a batch waits for "
                             "co-travellers")
    parser.add_argument("--pin_bucket", type=int, default=None,
                        help="dispatch every request/batch at this fixed bucket: seeded "
                             "responses become bit-identical under any load (different "
                             "buckets are different XLA executables), at the cost of padded "
                             "transfers")
    parser.add_argument("--serve_arnn", default="none", choices=["none", "baseline", "reg"],
                        help="also load an AnticipationRNN checkpoint (the reference's second "
                             "inpainting family) and serve it at POST /v1/arnn/inpaint")
    add_options(parser, [("arnn_num_layers", 2, None), ("arnn_lstm_hidden_size", 256, None),
                         ("arnn_linear_hidden_size", 256, None),
                         ("arnn_metadata_embedding_dim", 2, None),
                         ("arnn_dropout_lstm", 0.2,
                          "must match the training flag (checkpoints are config-addressed)"),
                         ("arnn_input_dropout", 0.2, None)])
    parser.add_argument("--arnn_note_embedding_dim", type=int, default=None,
                        help="defaults to --note_embedding_dim; set separately when the ARNN "
                             "was trained with a different size")
    flag_pair(parser, "arnn_teacher_forcing", "arnn_no_teacher_forcing", True,
              "must match the training flag (part of the checkpoint name)")
    dataset_options(parser)
    device_option(parser)
    return parser


def build_server(args):
    """The engines of the trained checkpoints behind a server (not yet
    started) of the parsed options."""
    from inpaintnet_tpu_torch.serve import InpaintingEngine
    from inpaintnet_tpu_torch.server import InpaintingServer

    device = resolve_device(args.device)
    folk_dataset_train, _ = standard_datasets(args.dataset_name, cache_dir=args.cache_dir,
                                              corpus_dir=args.corpus_dir)
    vae_model = build_vae(args, folk_dataset_train, device).load()
    model = build_latent_rnn(args, folk_dataset_train, vae_model, device,
                             auto_reg=args.auto_reg).load()
    buckets = tuple(int(b) for b in args.batch_buckets.split(","))
    engine = InpaintingEngine(model, batch_buckets=buckets, dtype=args.serve_dtype)
    arnn_engine = None
    if args.serve_arnn != "none":
        from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

        arnn_args = argparse.Namespace(
            note_embedding_dim=(args.arnn_note_embedding_dim
                                if args.arnn_note_embedding_dim is not None
                                else args.note_embedding_dim),
            metadata_embedding_dim=args.arnn_metadata_embedding_dim,
            num_layers=args.arnn_num_layers, lstm_hidden_size=args.arnn_lstm_hidden_size,
            linear_hidden_size=args.arnn_linear_hidden_size, dropout_lstm=args.arnn_dropout_lstm,
            input_dropout=args.arnn_input_dropout)
        arnn_model = build_arnn(arnn_args, folk_dataset_train, device, args.serve_arnn,
                                teacher_forcing=args.arnn_teacher_forcing).load()
        arnn_engine = ARNNServingEngine(
            arnn_model, batch_buckets=buckets,
            dtype="float32" if args.serve_dtype == "float32" else "bfloat16")
    if args.warmup:
        print("warming up (every bucket)...", flush=True)
        engine.warmup(hetero=args.batching)
        if arnn_engine is not None:
            arnn_engine.warmup(measures=16)
    return InpaintingServer(engine, host=args.host, port=args.port, quiet=False,
                            batching=args.batching, max_wait_ms=args.max_wait_ms,
                            pin_bucket=args.pin_bucket, arnn_engine=arnn_engine)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    server = build_server(args)
    print(f"serving on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
