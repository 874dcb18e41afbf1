"""Shared pieces of the benchmark's tests: the spec, small copies of each
cell's configuration and traffic for the CPU, and the card fixture."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402

SMALL = {
    "latent_rnn": {"encoder_hidden_size": 32, "decoder_hidden_size": 32, "latent_space_dim": 16,
                   "latent_rnn_hidden_size": 32, "note_embedding_dim": 6},
    "arnn": {"num_lstm_constraints_units": 32, "num_lstm_generation_units": 32,
             "linear_hidden_size": 32},
}
# bulk mixes at 8 tunes a call; every mix traces 2 calls
SMALL_BULK = {"rows": 8, "bucket": 8, "check_rows": 8, "pool": 4}


def small_parts(cell_name: str, widths: dict = None, **mix_over) -> tuple:
    """The cell's files at small widths and batch, for a CPU run."""
    spec = core.load_spec(ROOT)
    cell, entry, cfg, mix = core.cell_parts(spec, cell_name)
    cfg = copy.deepcopy(cfg)
    cfg.update(widths if widths is not None else SMALL[cfg["family"]])
    mix = dict(mix, trace_requests=2, **(SMALL_BULK if mix["rows"] > 1 else {}))
    mix.update(mix_over)
    return cell, entry, cfg, mix


@pytest.fixture
def spec():
    return core.load_spec(ROOT)


@pytest.fixture
def card():
    """Skips off an NVIDIA card; decided at run time, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
