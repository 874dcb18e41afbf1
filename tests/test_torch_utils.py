"""The port's utils (``inpaintnet_tpu_torch/utils``: rng, debug, timing,
profiling) and the trainer's ``debug=`` sweep, on the CPU; the twins of
the JAX package's ``inpaintnet_tpu/utils``."""
import time

import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
from inpaintnet_tpu_torch.train.data import ArrayDataset
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer
from inpaintnet_tpu_torch.utils.debug import assert_finite, checkify_wrap, nan_check
from inpaintnet_tpu_torch.utils.profiling import StepTimer
from inpaintnet_tpu_torch.utils.rng import RngStream
from inpaintnet_tpu_torch.utils.timing import device_timeit, fetch

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)


def test_nan_check_names_the_leaf():
    params = {"encoder": {"gru": [[{"w_hh": torch.ones(2, 3)}], [{"w_hh": torch.ones(2)}]]},
              "steps": np.arange(3)}
    nan_check(params)
    params["encoder"]["gru"][1][0]["w_hh"][1] = float("nan")
    with pytest.raises(ValueError, match="model params has become non-finite at "
                                         "encoder/gru/1/0/w_hh"):
        nan_check(params, "model params")
    with pytest.raises(ValueError, match="out contains non-finite"):
        assert_finite([torch.zeros(1), torch.tensor([float("inf")])], "out")


def test_checkify_wrap_returns_the_first_fault():
    def f(x, i):
        y = torch.log(x)  # NaN for x < 0
        return y[i] * 2.0

    wrapped = checkify_wrap(f)
    err, out = wrapped(torch.tensor([1.0, 2.0]), 1)
    assert err.get() is None and torch.equal(out, torch.log(torch.tensor(2.0)) * 2.0)
    err.throw()  # nothing to raise
    err, out = wrapped(torch.tensor([1.0, -2.0]), 0)
    assert "non-finite value produced by log" in err.get()
    with pytest.raises(ValueError, match="log"):
        err.throw()
    err, out = wrapped(torch.tensor([1.0, 2.0]), 5)
    assert "index out of range" in err.get() and out is None
    err, _ = checkify_wrap(lambda x: x / 0.0)(torch.ones(2))
    assert "non-finite" in err.get()


def test_rng_stream_is_deterministic():
    a, b = RngStream(5), RngStream(5)
    draws = [torch.rand(4, generator=g) for g in a.next_n(3)]
    again = [torch.rand(4, generator=g) for g in b.next_n(3)]
    for x, y in zip(draws, again):
        assert torch.equal(x, y)
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(torch.rand(4, generator=RngStream(6).next()), draws[0])


def test_step_timer_and_device_timeit_on_the_cpu():
    timer = StepTimer(items_per_step=10.0, warmup=1)
    for _ in range(4):
        with timer:
            time.sleep(0.002)
    assert len(timer._times) == 3 and timer.p50_ms >= 2.0
    assert timer.throughput > 0 and "items/s over 3 steps" in timer.report()
    assert np.isnan(StepTimer().p50_ms)
    x = torch.ones(64, 64)
    seconds = device_timeit(lambda a: a @ a, x, iters=3, warmup=1, reps=2)
    assert 0 < seconds < 1.0
    assert fetch([x, {"y": torch.ones(2)}]) == 64 * 64 + 2


def test_trainer_debug_stops_on_a_planted_nan():
    rng = np.random.default_rng(0)
    windows = rng.integers(0, 20, (8, 1, 48)).astype(np.int32)
    model = MeasureVAE(VocabOnlyDataset(20), note_embedding_dim=4, encoder_hidden_size=8,
                       latent_space_dim=4, decoder_hidden_size=8, device="cpu")
    trainer = VAETrainer(ArrayDataset([windows], 2), model, device="cpu", debug=True)
    loader = [(windows[:4],)]
    trainer.loss_and_acc_on_epoch(loader, train=False)  # finite: passes
    with torch.no_grad():
        trainer.params["decoder"]["head"]["b"][3] = float("nan")
    with pytest.raises(ValueError, match="MeasureVAE params has become non-finite at "
                                         "decoder/head/b"):
        trainer.loss_and_acc_on_epoch(loader, train=False)
    trainer.debug = False
    trainer.loss_and_acc_on_epoch(loader, train=False)  # no sweep: no raise
