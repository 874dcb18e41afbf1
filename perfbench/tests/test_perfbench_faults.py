"""A whole run with the timed path broken underneath must come out not
correct: once for each fault a serving cell can have (a token altered
where it is produced; half of the batch left out). The look for a card is
skipped: the runs are on the CPU at small widths, and the limits are the
configurations' own."""
import time

import numpy as np
import pytest

from conftest import small_parts
from perfbench import core


def alter_a_token(requests, outs):
    """Every returned tune's first span token moved to the next one."""
    for req, out in zip(requests, outs):
        s = req["start_measure"]
        out[:, s, 0] = (out[:, s, 0] + 1) % 60


def drop_half(requests, outs):
    """The later half of each call's tunes left as they came in."""
    for req, out in zip(requests, outs):
        s, n = req["start_measure"], req["num_measures"]
        half = max(len(out) // 2, 1)
        out[len(out) - half:, s:s + n] = req["tokens"][len(out) - half:, s:s + n]


WIDTHS = {"latent_rnn": {"encoder_hidden_size": 64, "decoder_hidden_size": 64,
                         "latent_space_dim": 32, "latent_rnn_hidden_size": 64,
                         "note_embedding_dim": 10},
          "arnn": {"num_lstm_constraints_units": 64, "num_lstm_generation_units": 64,
                   "linear_hidden_size": 64}}


@pytest.mark.parametrize("fault", [None, alter_a_token, drop_half])
@pytest.mark.parametrize("cell", ["latent512.bulk", "arnn256.bulk", "latent512.interactive"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    family = "arnn" if cell.startswith("arnn") else "latent_rnn"
    parts = small_parts(cell, widths=WIDTHS[family])
    if cell == "latent512.interactive" and fault is drop_half:
        # one tune a request: every other request goes unserved
        def fault(requests, outs, _seen=[0]):
            _seen[0] += 1
            if _seen[0] % 2:
                drop_half(requests, outs)
    result, _, _ = core.run_cell(cell, 2**32 + 99, 0.3, False, t0=time.perf_counter(),
                                 device="cpu", parts=parts, fault=fault)
    assert result["correct"] is (fault is None), result["checks"]


def test_drop_half_leaves_the_input_in_the_span():
    req = {"start_measure": 2, "num_measures": 1, "tokens": np.zeros((4, 5, 24), np.int32)}
    out = np.ones((4, 5, 24), np.int32)
    drop_half([req], [out])
    assert (out[:2, 2] == 1).all() and (out[2:, 2] == 0).all()
