"""PyTorch port: the VGG2L conv front (``enc_type: vggblstm``) against the
JAX package on the CPU, mirroring ``tests/test_vgg.py``: shapes and the
length math, outputs and every gradient with bridged flax parameters,
padding invariance, the deltas' channel split, and the bridge by name.

Tolerances: f32 (bf16 once, at the encoder tests' bf16 tolerance), the
JAX suite's LSTM tolerance (rtol 1e-5) widened to atol 1e-5 for values
that went through four convs, BiLSTM layers and a head, as
``tests/test_torch_encoder.py`` widens it; gradients rtol 1e-4 / atol
1e-5 of their largest entry, as the train-step tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import ModelConfig as JaxModelConfig
from gluon_e2e_asr_tpu.config import encoder_time_reduction as jax_reduction
from gluon_e2e_asr_tpu.models.asr import ASRModel as JaxASRModel
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, params_to_jax
from gluon_e2e_asr_tpu_torch.config import ModelConfig, encoder_time_reduction
from gluon_e2e_asr_tpu_torch.models.asr import ASRModel

torch.set_num_threads(1)

V = 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(cls, **kw):
    kw.setdefault("enc_type", "vggblstm")
    kw.setdefault("enc_hidden", 16)
    kw.setdefault("enc_layers", 2)
    kw.setdefault("enc_subsample", (1,))
    kw.setdefault("vgg_channels", (8, 16))
    kw.setdefault("compute_dtype", "float32")
    return cls(**kw)


def _feats(seed, B, T, D, lens):
    x = np.random.RandomState(seed).randn(B, T, D).astype(np.float32)
    for b, n in enumerate(lens):
        x[b, n:] = 0.0  # the frontend's contract: padded frames are zero
    return x


def _models(feats, lens, **kw):
    jmodel = JaxASRModel(_cfg(JaxModelConfig, **kw), V, use_decoder=False)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                         jnp.asarray(lens, jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = ASRModel(_cfg(ModelConfig, **kw), V, in_dim=feats.shape[-1])
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


def _both(jmodel, params, tmodel, feats, lens):
    ref = jmodel.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(lens, jnp.int32), method=jmodel.encode)
    with torch.inference_mode():
        got = tmodel.encode(torch.from_numpy(feats),
                            torch.tensor(lens, dtype=torch.int32))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("T,lens", [(37, [37, 21, 4, 1]), (40, [40, 39, 2, 3])])
def test_vgg_length_math_and_outputs_match_jax(T, lens):
    feats = _feats(0, 4, T, 40, lens)
    ref, got = _both(*_models(feats, lens), feats, lens)
    # two SAME 2x pools: T 37 -> 19 -> 10; len = ceil(ceil(len/2)/2)
    t_out = (((T + 1) // 2) + 1) // 2
    assert got[0].shape == (4, t_out, 32) and got[2].shape == (4, t_out, V)
    expect = [(((n + 1) // 2) + 1) // 2 for n in lens]
    np.testing.assert_array_equal(got[1], expect)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[2], ref[2], **TOL)
    cfg = _cfg(ModelConfig)
    assert encoder_time_reduction(cfg) == jax_reduction(
        _cfg(JaxModelConfig)) == 4
    assert ASRModel(cfg, V, 40).encoder.layer_frames(T) == [t_out, t_out]


def test_vgg_bf16_outputs_match_jax():
    """compute_dtype bf16 (vgg_blstm.yaml's): the convs take bf16 operands
    on both sides and round their outputs to bf16, in different orders,
    and h is rounded every step: the encoder tests' bf16 tolerance (atol
    1e-2 on values below 1)."""
    lens = [37, 21, 4, 1]
    feats = _feats(5, 4, 37, 40, lens)
    ref, got = _both(*_models(feats, lens, compute_dtype="bfloat16"), feats,
                     lens)
    np.testing.assert_array_equal(got[1], ref[1])
    assert np.abs(ref[0]).max() < 1
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-2)


def test_vgg_padding_invariance():
    """The valid encoder frames are the same whichever bucket length the
    utterance is padded to, in the port and in JAX."""
    n = 23
    core = np.random.RandomState(1).randn(1, n, 40).astype(np.float32)
    pad = {T: np.concatenate([core, np.zeros((1, T - n, 40), np.float32)], 1)
           for T in (24, 40)}
    models = _models(pad[24], [n])
    outs = {T: _both(*models, pad[T], [n]) for T in pad}
    for side in (0, 1):  # JAX, the port
        assert outs[24][side][1][0] == outs[40][side][1][0] == 6
        np.testing.assert_allclose(outs[24][side][0][:, :6],
                                   outs[40][side][0][:, :6], **TOL)
    np.testing.assert_allclose(outs[40][1][0], outs[40][0][0], **TOL)


def test_vgg_delta_channel_split():
    """vgg_in_channels=3 splits a [static|d|dd] feature axis into the
    conv's input channels; a divisor that does not divide raises."""
    lens = [16, 9]
    feats = _feats(2, 2, 16, 120, lens)  # 3 blocks of 40
    jmodel, params, tmodel = _models(feats, lens, vgg_in_channels=3)
    assert params["encoder"]["vgg"]["conv1_1"]["kernel"].shape == (3, 3, 3, 8)
    assert tmodel.encoder.vgg.conv1_1.kernel.shape == (3, 3, 3, 8)
    ref, got = _both(jmodel, params, tmodel, feats, lens)
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[2], ref[2], **TOL)
    with pytest.raises(ValueError, match="divisible"):
        ASRModel(_cfg(ModelConfig, vgg_in_channels=7), V, in_dim=120)


def test_vgg_gradients_match_jax():
    lens = [20, 11]
    feats = _feats(3, 2, 20, 40, lens)
    jmodel, params, tmodel = _models(feats, lens)

    def loss(p):
        _, _, lg = jmodel.apply({"params": p}, jnp.asarray(feats),
                                jnp.asarray(lens, jnp.int32),
                                method=jmodel.encode)
        return jnp.sum(lg ** 2)

    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    _, _, lg = tmodel.encode(torch.from_numpy(feats),
                             torch.tensor(lens, dtype=torch.int32))
    (lg ** 2).sum().backward()
    for name, p in tmodel.named_parameters():
        r = ref[name].numpy()
        assert np.isfinite(p.grad.numpy()).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_vgg_bridge_by_name():
    """Every leaf of the flax tree maps by name (strict load) and back, bit
    for bit; a conv whose leaves are not {kernel, bias} raises."""
    lens = [8]
    feats = _feats(4, 1, 8, 40, lens)
    _, params, tmodel = _models(feats, lens)
    names = sorted(k for k in tmodel.state_dict() if ".vgg." in k)
    assert names == sorted(f"encoder.vgg.conv{s}_{k}.{leaf}" for s in (1, 2)
                           for k in (1, 2) for leaf in ("kernel", "bias"))
    back = params_to_jax(tmodel.state_dict())["encoder"]["vgg"]
    for conv, leaves in params["encoder"]["vgg"].items():
        for leaf, v in leaves.items():
            assert back[conv][leaf].tobytes() == v.tobytes()
    with pytest.raises(KeyError, match="vgg"):
        params_from_jax({"encoder": {"vgg": {"conv1_1": {"kernel": 1}}}})
    with pytest.raises(KeyError, match="VGG2L"):
        params_from_jax({"encoder": {"vgg": {"pool1": {}}}})


def test_vgg_init_draws_flax_shapes_from_the_generator():
    a, b = (ASRModel(_cfg(ModelConfig), V, 40) for _ in range(2))
    for m in (a, b):
        m.encoder.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    k = a.encoder.vgg.conv2_1.kernel.detach()
    # lecun_normal: variance 1 / fan_in, fan_in = 3 * 3 * Cin
    np.testing.assert_allclose(float(k.std()), (1 / (9 * 8)) ** 0.5, rtol=0.15)
    assert not a.encoder.vgg.conv2_1.bias.any()
