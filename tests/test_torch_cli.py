"""The port's command line (``inpaintnet_tpu_torch/cli``) on the CPU: the
user's journey from a corpus to MIDI through each entry point's
``main(argv)`` at tiny widths, checkpoints shared with the JAX package,
the server as a subprocess, and every entry point's flags against its
click root script's (names, defaults, help, and how a bool reads)."""
import argparse
import glob
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

from inpaintnet_tpu_torch.cli import common
from inpaintnet_tpu_torch.data.midi import read_midi_notes

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["train_measure_vae", "train_inpaintnet", "train_inpaintnet_ablation",
           "train_arnn_reg", "train_arnn_baseline", "test_reconstruction",
           "script_gen_diff_models", "script_gen_same_context", "run_server"]
TINY = ["--note_embedding_dim", "8", "--num_encoder_layers", "1", "--encoder_hidden_size", "16",
        "--latent_space_dim", "12", "--num_decoder_layers", "1", "--decoder_hidden_size", "16"]
TINY_LATENT = ["--num_latent_rnn_layers", "2", "--latent_rnn_hidden_size", "16"]
TINY_ARNN = ["--metadata_embedding_dim", "4", "--num_layers", "1", "--lstm_hidden_size", "16",
             "--linear_hidden_size", "12"]
TRAIN = ["--batch_size", "4", "--num_epochs", "1", "--no_log"]


def _cli(name):
    return importlib.import_module(f"inpaintnet_tpu_torch.cli.{name}")


def _root(name):
    """The JAX package's root script ``name``.py as a module."""
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def journey(tmp_path_factory):
    """The journey in a fresh working directory (checkpoints/ and runs/
    land there): a corpus, its statistics, both VAE-based models and the
    past ablation, both ARNNs, the joint evaluation. -> (workdir, the
    dataset flags, {step: its printed output or return value})"""
    import contextlib
    import io

    wd = tmp_path_factory.mktemp("journey")
    cwd = os.getcwd()
    os.chdir(wd)
    out = {}
    try:
        data = ["--dataset_name", "folk_4by4nbars_short", "--corpus_dir", "corpus",
                "--cache_dir", "cache", "--device", "cpu"]

        def run(step, name, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = _cli(name).main(argv)
            out[step] = (buf.getvalue(), result)

        run("synth", "prepare_corpus", ["synth", "--out_dir", "corpus", "--num_tunes", "8",
                                        "--num_bars", "16", "--seed", "3"])
        run("stats", "prepare_corpus", ["stats", "--corpus_dir", "corpus", "--cache_dir", "cache"])
        run("vae", "train_measure_vae", TINY + data + TRAIN)
        run("latent", "train_inpaintnet", TINY + TINY_LATENT + data + TRAIN + ["--no_auto_reg"])
        run("past", "train_inpaintnet_ablation",
            TINY + TINY_LATENT + data + TRAIN + ["--no_plot", "--no_early_stop", "--no_auto_reg",
                                                 "--context_type", "past"])
        # the baseline keeps --plot's default (True): runs/<name>.png and .jsonl
        run("arnn_baseline", "train_arnn_baseline",
            ["--note_embedding_dim", "8"] + TINY_ARNN + data
            + ["--batch_size", "4", "--num_epochs", "1", "--no_early_stop"])
        run("arnn", "train_arnn_reg", ["--note_embedding_dim", "8"] + TINY_ARNN + data + TRAIN
            + ["--no_plot", "--no_early_stop"])
        run("joint", "test_reconstruction", TINY + TINY_LATENT + TINY_ARNN + data
            + ["--batch_size", "4", "--num_target", "2", "--include_ablations", "past"])
        run("same_context", "script_gen_same_context", TINY + TINY_LATENT + data
            + ["--num_generations", "3", "--save_folder", "same"])
        run("diff_models", "script_gen_diff_models", TINY + TINY_LATENT + TINY_ARNN + data
            + ["--num_melodies", "3", "--save_folder", "diff"])
        yield str(wd), data, out
    finally:
        os.chdir(cwd)


def test_corpus_commands(journey):
    _, _, out = journey
    assert "wrote 8 synthetic tunes to corpus" in out["synth"][0]
    assert "valid tunes: 8" in out["stats"][0]


@pytest.mark.parametrize("step", ["vae", "latent", "past", "arnn", "arnn_baseline"])
def test_training_prints_the_test_loss(journey, step):
    _, _, out = journey
    printed, (loss, acc) = out[step]
    assert "Test Loss" in printed and "Train Epoch: 1/1" in printed
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0


def test_plot_writes_the_curves(journey):
    """``--plot`` (the ARNN baseline's default) logs the epoch and draws it."""
    wd, _, _ = journey
    logs = glob.glob(os.path.join(wd, "runs", "*.jsonl"))
    assert len(logs) == 1 and glob.glob(os.path.join(wd, "runs", "*.png"))
    assert json.loads(open(logs[0]).readline())["epoch_index"] == 0


def test_joint_eval_prints_every_row(journey):
    _, _, out = journey
    printed, results = out["joint"]
    for name in ("latent_rnn", "arnn", "arnn_baseline", "ablation_past"):
        assert f"{name}_loss: " in printed and np.isfinite(results[f"{name}_loss"])
        assert 0.0 <= results[f"{name}_acc"] <= 1.0
    assert "repeat_fraction" in results


@pytest.mark.parametrize("step,count", [("same_context", 3), ("diff_models", None)])
def test_generation_writes_midi(journey, step, count):
    _, _, out = journey
    printed, paths = out[step]
    assert paths and (count is None or len(paths) == count)
    if count is None:  # original, LatentRNN, ARNN-reg, ARNN-baseline per usable tune
        assert len(paths) % 4 == 0 and f"wrote {len(paths)} MIDI files" in printed
    for path in paths:
        with open(path, "rb") as f:
            assert f.read(4) == b"MThd"
        assert read_midi_notes(path)
    if step == "same_context":  # one tune's context: the same first note
        assert len({read_midi_notes(p)[0] for p in paths}) == 1


def _jax_flat(params) -> dict:
    """A JAX parameter pytree as ``{"a/0/b": array}``, the checkpoints' keys."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _model_args(argv):
    """The parsed model options of ``argv`` (the joint eval's parser has them all)."""
    return _cli("test_reconstruction").build_parser().parse_args(argv)


def test_checkpoints_round_trip_with_jax(journey, tmp_path):
    """The port's trained VAE loads in the JAX package, and an ARNN
    checkpoint the JAX package wrote loads in the port: the same file
    names (config-addressed) and parameters."""
    from inpaintnet_tpu.data import BeatMarkerMetadata, DatasetManager, TickMetadata
    from inpaintnet_tpu.models import ConstraintModelGaussianReg, MeasureVAE
    from inpaintnet_tpu_torch.models.base import flatten_params

    wd, data, _ = journey
    jds = DatasetManager(cache_dir=os.path.join(wd, "cache"),
                         corpus_dir=os.path.join(wd, "corpus")).get_dataset(
        "folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6), TickMetadata(6)],
        sequences_size=32, num_bars=16, train=True)
    tds, _ = common.standard_datasets("folk_4by4nbars_short", os.path.join(wd, "cache"),
                                      os.path.join(wd, "corpus"))
    ckpt = os.path.join(wd, "checkpoints")
    jvae = MeasureVAE(jds, note_embedding_dim=8, num_encoder_layers=1, encoder_hidden_size=16,
                      latent_space_dim=12, num_decoder_layers=1, decoder_hidden_size=16,
                      checkpoint_dir=ckpt)
    jvae.init(jax.random.PRNGKey(0))
    jvae.load()
    tvae = common.build_vae(_model_args(TINY + data), tds, "cpu")
    tvae.checkpoint_dir = ckpt
    assert tvae.filepath == jvae.filepath
    tvae.load()
    got, want = flatten_params(tvae.params()), _jax_flat(jvae.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])

    other = str(tmp_path / "ckpt")
    jarnn = ConstraintModelGaussianReg(jds, note_embedding_dim=8, metadata_embedding_dim=4,
                                       num_lstm_constraints_units=16,
                                       num_lstm_generation_units=16, linear_hidden_size=12,
                                       num_layers=1, dropout_prob=0.2, dropout_input_prob=0.2,
                                       unary_constraint=True, checkpoint_dir=other)
    jarnn.init(jax.random.PRNGKey(9))
    jarnn.save()
    arnn = common.build_arnn(_model_args(["--note_embedding_dim", "8"] + TINY_ARNN + data),
                             tds, "cpu", "reg")
    arnn.checkpoint_dir = other
    assert arnn.filepath == jarnn.filepath
    got, want = flatten_params(arnn.load().params()), _jax_flat(jarnn.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_run_server_answers_healthz(journey):
    """``python -m inpaintnet_tpu_torch.cli.run_server`` on the journey's
    checkpoints: /healthz and one /v1/inpaint answer, then it stops."""
    wd, data, _ = journey
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "inpaintnet_tpu_torch.cli.run_server", *TINY, *TINY_LATENT,
         *data, "--port", "0", "--serve_dtype", "float32"],
        cwd=wd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            found = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(found.group(1)) if found else None
        assert port, "the server never said where it serves"
        health = json.load(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30))
        assert health["status"] == "ok"
        tokens = np.random.default_rng(0).integers(0, 10, (1, 8, 24)).tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/inpaint", method="POST",
            data=json.dumps({"tokens": tokens, "start_measure": 3, "num_measures": 2,
                             "seed": 1}).encode(),
            headers={"Content-Type": "application/json"})
        got = np.asarray(json.load(urllib.request.urlopen(req, timeout=60))["tokens"])
        assert got.shape == (1, 8, 24)
        np.testing.assert_array_equal(got[:, :3], np.asarray(tokens)[:, :3])
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.poll() is not None


def test_cuda_without_a_card_raises():
    """``--device cuda`` (the default) where torch sees no card stops; it
    never carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(SystemExit, match="cuda"):
        common.resolve_device("cuda")
    with pytest.raises(SystemExit):
        _cli("train_measure_vae").main(TINY + ["--corpus_dir", "nowhere"])


def _click_params(command):
    return {p.name: p for p in command.params}


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_match_the_root_script(name):
    """Every click option of the root script is an argparse option of its
    twin with the same default and help; a click flag pair is two flags on
    one destination; a bool option reads the words click's BOOL reads. The
    twin adds only ``--device``."""
    import click

    command = _root(name).main
    parser = _cli(name).build_parser()
    actions = {s: a for a in parser._actions for s in a.option_strings}
    click_opts = set()
    for p in command.params:
        click_opts.update(p.opts + p.secondary_opts)
        action = actions[p.opts[0]]
        assert action.dest == p.name and action.default == p.default, p.name
        assert action.help == p.help, p.name
        if p.secondary_opts:
            off = actions[p.secondary_opts[0]]
            assert off.dest == p.name and isinstance(off, argparse._StoreFalseAction)
            assert parser.parse_args([p.secondary_opts[0]]).__dict__[p.name] is False
            assert parser.parse_args([p.opts[0]]).__dict__[p.name] is True
        elif isinstance(p.type, click.types.BoolParamType):
            for word in ("True", "False", "yes", "n", "0", "ON"):
                assert (parser.parse_args([p.opts[0], word]).__dict__[p.name]
                        is p.type.convert(word, p, None)), word
        elif isinstance(p.type, click.Choice):
            assert list(action.choices) == list(p.type.choices)
        elif p.default is not None:
            assert (action.type or str) is type(p.default), p.name
    assert set(actions) - click_opts == {"-h", "--help", "--device"}


def test_prepare_corpus_matches_the_root_group():
    group = _root("prepare_corpus").cli
    parser = _cli("prepare_corpus").build_parser()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == set(group.commands)
    for cmd_name, command in group.commands.items():
        actions = {s: a for a in sub.choices[cmd_name]._actions for s in a.option_strings}
        for p in command.params:
            action = actions[p.opts[0]]
            default = None if p.required else p.default
            assert (action.default, action.help, action.required) == (default, p.help,
                                                                      p.required), p.name
        assert set(actions) - {s for p in command.params for s in p.opts} == {"-h", "--help"}


def test_click_bool_rejects_other_words():
    with pytest.raises(argparse.ArgumentTypeError):
        common.click_bool("maybe")
