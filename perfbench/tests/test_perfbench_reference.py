"""The plain references against the port's eager path on the CPU, their
control, and what they import."""
import subprocess
import sys
import time

import pytest

from conftest import ROOT, small_parts
from perfbench import core

F32 = {"param_dtype": "float32", "serve_dtype": "float32"}


def _run(cell, parts, **kw):
    result, lines, loaded = core.run_cell(cell, 2**31 + 4242, 0.3, False, t0=time.perf_counter(),
                                          device="cpu", parts=parts, **kw)
    return result, loaded


@pytest.mark.parametrize("cell", ["latent512.bulk", "arnn256.bulk", "latent512.interactive"])
def test_reference_agrees_with_the_port_in_f32(cell):
    """In float32 the port's eager path and the reference differ by
    rounding alone: no served token lies more than 1e-4 below the best."""
    parts = small_parts(cell)
    parts[2].update(F32)
    result, loaded = _run(cell, parts)
    assert result["checks"]["widest_gap"]["value"] < 1e-4
    assert result["checks"]["outside_span_changed"]["value"] == 0
    assert result["correct"] and loaded == []


@pytest.mark.parametrize("cell", ["latent512.bulk", "latent512.interactive"])
def test_int8_control_reads_wider_gaps_than_bf16(cell):
    """The LatentRNN's control, the program's int8 path, departs from the
    reference by more than its bf16 path does (at 64 units)."""
    widths = {"encoder_hidden_size": 64, "decoder_hidden_size": 64, "latent_space_dim": 32,
              "latent_rnn_hidden_size": 64, "note_embedding_dim": 10}
    gaps = {}
    for variant in (None, "control"):
        result, _ = _run(cell, small_parts(cell, widths=widths, check_rows=16), variant=variant)
        gaps[variant] = result["checks"]["widest_gap"]["value"]
    assert gaps["control"] > 3 * gaps[None]


def test_fp8_control_departs_from_the_reference():
    """The ARNN's control, the float8 reference's first tokens, lies below
    the float32 reference's best where the bf16 program does not (at 128
    units, 16 rows)."""
    widths = {"num_lstm_constraints_units": 128, "num_lstm_generation_units": 128,
              "linear_hidden_size": 128}
    gaps = {}
    for variant in (None, "control"):
        result, _ = _run("arnn256.bulk", small_parts("arnn256.bulk", widths=widths, rows=16,
                                                     bucket=64, check_rows=16),
                         variant=variant)
        gaps[variant] = result["checks"]["widest_gap"]["value"]
    assert gaps["control"] > 3 * gaps[None]


def _imports(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """The whole top-level name is compared: ``inpaintnet_tpu_torch``
    begins with ``inpaintnet_tpu``."""
    top = _imports(
        "import sys, time; sys.path.insert(0, 'perfbench/tests')\n"
        "from conftest import small_parts\n"
        "from perfbench import core\n"
        "for cell in ('latent512.bulk', 'arnn256.bulk'):\n"
        "    core.run_cell(cell, 3, 0.1, True, t0=time.perf_counter(), device='cpu',\n"
        "                  parts=small_parts(cell))\n")
    assert "inpaintnet_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "inpaintnet_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    top = _imports("import perfbench.reference.latent_rnn, perfbench.reference.arnn, "
                   "perfbench.reference.noise, perfbench.flops, perfbench.weights, "
                   "perfbench.generator")
    assert not top & {"jax", "jaxlib", "flax", "inpaintnet_tpu", "inpaintnet_tpu_torch"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "inpaintnet_tpu_torchish", sys)
    assert "inpaintnet_tpu_torchish" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "inpaintnet_tpu.serve", sys)
    assert "inpaintnet_tpu.serve" in core.forbidden_modules()
