"""The slice as a whole: the port's Encoder, decoder and non-autoregressive
LatentRNN against the JAX package's, with JAX's parameters converted by
``from_jax_params`` and JAX's own rsample noise, on the CPU in f32.

hidden 64 takes the kernel route (whose CPU branch is the plain version);
hidden 16 the eager GRU loops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset, build_latent_rnn

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-4  # f32 end to end: loops of matmuls in another summation order
VOCAB, EMB, Z = 30, 8, 12


def _jax_models(hidden, seed=0):
    rng = np.random.default_rng(seed)
    ds = JaxVocabOnlyDataset(VOCAB)
    vae = JaxMeasureVAE(ds, note_embedding_dim=EMB, num_encoder_layers=2,
                        encoder_hidden_size=hidden, latent_space_dim=Z,
                        num_decoder_layers=2, decoder_hidden_size=hidden)
    vae.init(jax.random.PRNGKey(seed))
    model = JaxLatentRNN(ds, vae, num_rnn_layers=2, rnn_hidden_size=hidden, dropout=0.5)
    model.init(jax.random.PRNGKey(seed + 1))

    def jitter(tree):  # zero biases would hide bias bugs
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
            tree)

    vae.params, model.params = jitter(vae.params), jitter(model.params)
    return vae, model


def _port(jvae, jmodel, hidden):
    vae, model = build_latent_rnn(VocabOnlyDataset(VOCAB), emb=EMB, hidden=hidden, z_dim=Z,
                                  layers=2, vae_params_np=jvae.params,
                                  latent_params_np=jmodel.params, device="cpu")
    return vae, model


@pytest.mark.parametrize("hidden", [16, 64])
def test_encoder_apply_matches_jax(hidden):
    jvae, jmodel = _jax_models(hidden)
    vae, _ = _port(jvae, jmodel, hidden)
    assert vae.encoder.use_kernel()  # H 16: K1 on zero units (its plain version here)
    tokens = np.random.default_rng(1).integers(0, VOCAB, (9, 24)).astype(np.int32)
    jd = jvae.encoder.apply(jax.tree_util.tree_map(jnp.asarray, jvae.params["encoder"]),
                            jnp.asarray(tokens), train=False)
    td = vae.encoder.apply(vae.params()["encoder"], torch.from_numpy(tokens))
    np.testing.assert_allclose(td.loc.detach().numpy(), np.asarray(jd.loc), atol=ATOL)
    np.testing.assert_allclose(td.scale.detach().numpy(), np.asarray(jd.scale), atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 64])
def test_decode_sampling_matches_jax(hidden):
    jvae, jmodel = _jax_models(hidden, seed=2)
    vae, _ = _port(jvae, jmodel, hidden)
    z = np.random.default_rng(3).standard_normal((7, Z)).astype(np.float32)
    jw, js = jvae.decoder.decode_sampling(
        jax.tree_util.tree_map(jnp.asarray, jvae.params["decoder"]), jnp.asarray(z),
        train=False, rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        tw, ts = vae.decoder.decode_sampling(vae.params()["decoder"], torch.from_numpy(z))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 64])
def test_latent_rnn_apply_matches_jax(hidden):
    jvae, jmodel = _jax_models(hidden, seed=4)
    _, model = _port(jvae, jmodel, hidden)
    rng = np.random.default_rng(5)
    B, M, Mt = 4, 5, 3
    past = rng.integers(0, VOCAB, (B, M, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (B, M, 24)).astype(np.int32)
    pm = (np.arange(M)[None] < np.array([[1], [3], [5], [2]])).astype(np.float32)
    fm = (np.arange(M)[None] < np.array([[0], [2], [5], [4]])).astype(np.float32)  # row 0: no future
    tm = (np.arange(Mt)[None] < np.array([[3], [1], [2], [3]])).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jw, js, jz = jmodel.apply(
        jax.tree_util.tree_map(jnp.asarray, jmodel.params),
        jax.tree_util.tree_map(jnp.asarray, jvae.params),
        jnp.asarray(past), jnp.asarray(future), None, past_mask=pm, future_mask=fm,
        target_mask=tm, train=False, rng=key)
    # JAX's rsample noise: keys = split(rng, 8); r_enc, r_z = split(keys[0])
    _, r_z = jax.random.split(jax.random.split(key, 8)[0])
    eps = np.array(jax.random.normal(r_z, (B * 2 * M, Z)))
    with torch.no_grad():
        tw, ts, tz = model.apply(
            model.params(), model.vae_model.params(), torch.from_numpy(past),
            torch.from_numpy(future), None, past_mask=torch.from_numpy(pm),
            future_mask=torch.from_numpy(fm), target_mask=torch.from_numpy(tm),
            eps=torch.from_numpy(eps))
    assert ts.shape == (B, Mt, 24) and tw.shape == (B, Mt, 24, VOCAB)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


def test_latent_rnn_geometry_and_autoreg_guards():
    ds = VocabOnlyDataset(VOCAB)
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE

    vae = MeasureVAE(ds, note_embedding_dim=EMB, encoder_hidden_size=16, latent_space_dim=Z,
                     decoder_hidden_size=16, device="meta")
    with pytest.raises(ValueError, match="num_rnn_layers == 2"):
        LatentRNN(vae, num_rnn_layers=3, rnn_hidden_size=16, device="meta")
    # the autoregressive model: a z-wide generation input and no x_0
    auto = LatentRNN(vae, num_rnn_layers=2, rnn_hidden_size=16, auto_reg=True, device="meta")
    assert auto.generation_rnn.weight_ih_l0.shape == (3 * 32, Z)
    assert auto.generation_linear.in_features == 64 and not hasattr(auto, "x_0")
