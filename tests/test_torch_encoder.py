"""PyTorch port: the encoder (3 pyramidal BiLSTM layers + CTC head, with
bridged flax parameters), ``subsample_concat`` and greedy CTC decoding
against the JAX package on the CPU.

Tolerances: f32 as the JAX suite's LSTM paths, widened to atol 1e-5
for values that went through three layers and a head; in bf16, h is
rounded every step, so a sum-order difference can flip one bf16
rounding (2^-8 relative); the outputs here are below 1 in magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import ModelConfig
from gluon_e2e_asr_tpu.models.asr import ASRModel as JaxASRModel
from gluon_e2e_asr_tpu.models.encoder import subsample_concat as jax_subsample
from gluon_e2e_asr_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
from gluon_e2e_asr_tpu_torch.models.encoder import subsample_concat
from gluon_e2e_asr_tpu_torch.ops.ctc import ctc_greedy_decode

torch.set_num_threads(1)

B, T, F, V = 3, 37, 20, 12  # T odd: the pyramid pads
LENS = np.array([37, 20, 5], np.int32)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.0, atol=1e-2)}


def _models(lstm_impl, cd):
    cfg = ModelConfig(enc_hidden=16, enc_layers=3, enc_subsample=(1, 2, 2),
                      lstm_impl=lstm_impl, compute_dtype=cd)
    feats = np.random.RandomState(0).randn(B, T, F).astype(np.float32)
    jmodel = JaxASRModel(cfg, V, use_decoder=False)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                         jnp.asarray(LENS))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = ASRModel(cfg, V, in_dim=F)
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel, feats


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("lstm_impl", ["scan", "pallas"])
def test_encoder_matches_jax(lstm_impl, cd):
    jmodel, params, tmodel, feats = _models(lstm_impl, cd)
    ref = jmodel.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(LENS), method=jmodel.encode)
    with torch.inference_mode():
        got = tmodel.encode(torch.from_numpy(feats), torch.from_numpy(LENS))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL[cd])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               **TOL[cd])


def test_encoder_forward_dict():
    _, _, tmodel, feats = _models("pallas", "float32")
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(feats), torch.from_numpy(LENS))
    assert set(out) == {"enc", "enc_len", "ctc_logits"}
    assert out["ctc_logits"].shape == (B, 10, V)  # ceil(ceil(37/2)/2)


def test_seeded_init_is_reproducible_and_flax_shaped():
    cfg = ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2))
    a, b = ASRModel(cfg, V, F), ASRModel(cfg, V, F)
    a.encoder.reset_parameters(torch.Generator().manual_seed(7))
    b.encoder.reset_parameters(torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.encoder.l0_rec_f.detach()
    # orthogonal [H, 4H]: orthonormal rows
    torch.testing.assert_close(w @ w.T, torch.eye(16), atol=1e-5, rtol=0)
    assert a.encoder.l1_in_w.shape == (2 * 2 * 16, 8 * 16)


def test_vggblstm_is_not_ported():
    """enc_type vggblstm raised until the port ran it; now the VGG2L front
    and its BiLSTM stack match the JAX encoder (tests/test_torch_vgg.py
    holds the rest), and an unknown enc_type raises."""
    cfg = ModelConfig(enc_type="vggblstm", enc_hidden=16, enc_layers=1,
                      enc_subsample=(1,), vgg_channels=(4, 8))
    feats = np.random.RandomState(5).randn(B, T, F).astype(np.float32)
    for b, n in enumerate(LENS):
        feats[b, n:] = 0.0
    jmodel = JaxASRModel(cfg, V, use_decoder=False)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(LENS))["params"])
    ref = jmodel.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(LENS), method=jmodel.encode)
    model = ASRModel(cfg, V, F)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(feats), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               **TOL["float32"])
    with pytest.raises(ValueError, match="enc_type"):
        ASRModel(ModelConfig(enc_type="transformer"), V, F)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_subsample_concat_matches_jax(factor):
    x = np.random.RandomState(1).randn(B, T, 4).astype(np.float32)
    ref = jax_subsample(jnp.asarray(x), jnp.asarray(LENS), factor)
    got = subsample_concat(torch.from_numpy(x), torch.from_numpy(LENS), factor)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("ties", [False, True])
def test_ctc_greedy_decode_matches_jax(ties):
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 15, 6).astype(np.float32)
    if ties:  # small integers: many equal maxima, first one wins in both
        logits = rng.randint(0, 3, size=logits.shape).astype(np.float32)
    lens = np.array([15, 9, 1, 0], np.int32)
    ref_ids, ref_len = jax_greedy(jnp.asarray(logits), jnp.asarray(lens))
    ids, out_len = ctc_greedy_decode(torch.from_numpy(logits),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_ctc_greedy_decode_keeps_every_frame():
    # Every frame kept (no blanks, no repeats): no dropped symbol lands on
    # the last column.
    logits = torch.full((1, 5, 6), -1.0)
    for t, s in enumerate([1, 2, 3, 4, 5]):
        logits[0, t, s] = 1.0
    ids, n = ctc_greedy_decode(logits, torch.tensor([5]))
    assert n.tolist() == [5] and ids.tolist() == [[1, 2, 3, 4, 5]]
