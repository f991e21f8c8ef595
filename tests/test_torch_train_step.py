"""PyTorch port: training steps against the JAX package's
``make_train_step`` on the CPU.

A tiny CTC-only config (``loss.mtl_alpha: 1.0``) and tiny hybrid ones
(``mtl_alpha: 0.3``, a dot-attention, and a location-aware (4 channels, a
width-7 filter) decoder with ``dec_impl: pallas``, label smoothing 0.1,
scheduled sampling 0), f32, SpecAugment masks 0
(the deterministic setup of ``__graft_entry__.py``), the JAX parameters
bridged into the port and a fresh optimizer state on both sides. The
JAX model runs ``lstm_impl: pallas`` (``bilstm_fused``, the CTC kernels
and the fused decoder in interpret mode); the port runs its plain
versions.
Tolerances: the loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-5 (the
JAX suite's pallas-against-scan tolerance); parameters after Adam: the
update divides by sqrt(nu), so a gradient entry near 0 with a different
rounding moves its parameter by a different fraction of the LR: atol
of 1% of the summed LRs, 1.5e-4 after 3 steps here (measured 3.7e-5;
gradients 6e-7).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluon_e2e_asr_tpu.config import Config, ModelConfig
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.ops.losses import hybrid_loss as jax_hybrid_loss
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD
from gluon_e2e_asr_tpu_torch.ops.losses import hybrid_loss
from gluon_e2e_asr_tpu_torch.training.train_step import draw_coins, ss_prob
from gluon_e2e_asr_tpu_torch.training import train_step as T

torch.set_num_threads(1)

VOCAB = 11


def _config(**train):
    c = Config()
    c.model = ModelConfig(enc_hidden=8, enc_layers=2, enc_subsample=(1, 2),
                          lstm_impl="pallas", compute_dtype="float32")
    c.loss.mtl_alpha = 1.0
    c.frontend.specaug_freq_masks = 0
    c.frontend.specaug_time_masks = 0
    c.train.learning_rate = 1e-2
    c.train.warmup_steps = 2
    for k, v in train.items():
        setattr(c.train, k, v)
    return c


def _hybrid_config():
    c = _config()
    c.model = ModelConfig(enc_hidden=8, enc_layers=2, enc_subsample=(1, 2),
                          lstm_impl="pallas", compute_dtype="float32",
                          dec_hidden=8, dec_embed=6, att_dim=8,
                          att_type="dot", dec_impl="pallas")
    c.loss.mtl_alpha = 0.3
    c.loss.label_smoothing = 0.1
    c.loss.scheduled_sampling = 0.0
    return c


def _loc_config():
    c = _hybrid_config()
    c.model.att_type = "loc"
    c.model.loc_conv_channels, c.model.loc_conv_width = 4, 7
    return c


def _m2_config(impl):
    """Milestone 2 (configs/milestone2_fused_frontend.yaml) cut to size:
    the fused frontend (``impl`` pallas or pallas_regrid, utterance CMVN),
    a CTC-only blstm encoder."""
    c = _config()
    c.frontend.impl = impl
    c.model.enc_layers, c.model.enc_subsample = 3, (1, 2, 2)
    return c


def _batch(seed=0, pad_row=False):
    rng = np.random.RandomState(seed)
    B, S, L = 3, 4800, 5
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    audio_len = np.array([4800, 3600, 2400], np.int32)
    labels = rng.randint(1, VOCAB, size=(B, L)).astype(np.int32)
    label_len = np.array([5, 3, 2], np.int32)
    labels[1, 3:] = labels[2, 2:] = 0
    if pad_row:  # a row of the batch that holds no utterance
        audio = np.concatenate([audio, np.zeros((1, S), np.float32)])
        audio_len = np.append(audio_len, 0).astype(np.int32)
        labels = np.concatenate([labels, np.zeros((1, L), np.int32)])
        label_len = np.append(label_len, 0).astype(np.int32)
    return {"audio": audio, "audio_len": audio_len, "labels": labels,
            "label_len": label_len}


def _jax_setup(config, batch):
    model = jax_build_model(config, VOCAB)
    assert model.use_decoder == (config.loss.mtl_alpha < 1.0)
    tx = jts.make_optimizer(config)
    state = jts.create_train_state(config, model, tx, batch)
    return model, tx, state


def _port_setup(config, jax_params):
    model = build_model(config, VOCAB, train=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_params)))
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0, opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(0))
    return model, opt, state


def _flat(tree):
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    return {k: v.numpy() for k, v in flat.items()}


def _three_steps(config, batch):
    """Three JAX steps and three port steps from the same parameters."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jmodel, tx, jstate = _jax_setup(config, batch)
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    (loss, jm), jgrads = jax.value_and_grad(jts.compute_loss, has_aux=True)(
        jstate.params, jb, jstate.rng, model=jmodel, config=config)
    step = jts.make_train_step(jmodel, config, tx)
    jax_params, jax_metrics = [], []
    st = jstate
    for _ in range(3):
        st, m = step(st, jb)
        jax_params.append(_flat(st.params))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    model, opt, state = _port_setup(config, init)
    fn = T.make_train_step(model, config, opt)
    port_params, port_metrics, port_grads = [], [], None
    for _ in range(3):
        m = fn(state, tb)
        if port_grads is None:
            port_grads = {k: p.grad.numpy().copy()
                          for k, p in model.named_parameters()}
        port_params.append({k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()})
        port_metrics.append({k: float(v) for k, v in m.items()})
    return dict(jax_loss=float(loss), jax_grads=_flat(jgrads),
                jax_params=jax_params, jax_metrics=jax_metrics,
                port_grads=port_grads, port_params=port_params,
                port_metrics=port_metrics, init=_flat(init), config=config,
                opt=opt)


@pytest.fixture(scope="module")
def runs():
    return _three_steps(_config(), _batch())


@pytest.fixture(scope="module")
def hybrid_runs():
    return _three_steps(_hybrid_config(), _batch(pad_row=True))


@pytest.fixture(scope="module")
def loc_runs():
    return _three_steps(_loc_config(), _batch(pad_row=True))


@pytest.fixture(scope="module", params=["pallas", "pallas_regrid"])
def m2_runs(request):
    return _three_steps(_m2_config(request.param), _batch(seed=1, pad_row=True))


def test_milestone2_steps_match_jax(m2_runs):
    """The JAX step runs K5 or K6 in interpret mode, the port their plain
    versions: the first step's loss and every gradient, and each of the
    three steps' gradient norm. (The parameters after Adam are held by the
    tests above; here the features of the two frontends differ by about
    1e-6, which Adam's division by sqrt(nu) can blow up for an entry
    whose gradient is near 0.)"""
    m = m2_runs["port_metrics"][0]
    np.testing.assert_allclose(m["loss"], m2_runs["jax_loss"], rtol=1e-5)
    assert set(m2_runs["port_grads"]) == set(m2_runs["jax_grads"])
    for k, g in m2_runs["port_grads"].items():
        np.testing.assert_allclose(g, m2_runs["jax_grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for m, jm in zip(m2_runs["port_metrics"], m2_runs["jax_metrics"]):
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)


def test_loss_and_metrics_match(runs):
    m, jm = runs["port_metrics"][0], runs["jax_metrics"][0]
    np.testing.assert_allclose(m["loss"], runs["jax_loss"], rtol=1e-5)
    for k in ("loss", "loss_ctc", "loss_att", "num_real"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_every_gradient_leaf_matches(runs):
    assert set(runs["port_grads"]) == set(runs["jax_grads"])
    for k, g in runs["port_grads"].items():
        np.testing.assert_allclose(g, runs["jax_grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_grad_norm_matches(runs):
    for m, jm in zip(runs["port_metrics"], runs["jax_metrics"]):
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)


def test_first_update_runs_at_lr_zero(runs):
    for k, v in runs["port_params"][0].items():
        np.testing.assert_array_equal(v, runs["init"][k], err_msg=k)
        np.testing.assert_array_equal(runs["jax_params"][0][k], runs["init"][k])


@pytest.mark.parametrize("n", [1, 3])
def test_parameters_after_adam_match(runs, n):
    opt = runs["opt"]
    atol = 0.01 * sum(opt.lr(i) for i in range(n)) + 1e-7
    for k, v in runs["port_params"][n - 1].items():
        np.testing.assert_allclose(v, runs["jax_params"][n - 1][k], rtol=0,
                                   atol=atol, err_msg=k)
    moved = sum(np.abs(v - runs["init"][k]).max()
                for k, v in runs["port_params"][n - 1].items())
    assert (moved > 0) == (n > 1)


def test_learning_rate_matches_the_optax_schedule():
    lr, w = 2e-3, 40
    config = _config(learning_rate=lr, warmup_steps=w)
    # The schedule of gluon_e2e_asr_tpu/training/train_step.py:45-53.
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, w),
         lambda s: lr * jnp.sqrt(w / jnp.maximum(s + w, 1))], [w])
    opt = T.make_optimizer(config)
    for step in (0, 1, w - 1, w, w + 5, 10 * w):
        np.testing.assert_allclose(opt.lr(step), float(sched(step)),
                                   rtol=1e-6, err_msg=str(step))
    assert opt.lr(0) == 0.0
    flat = T.make_optimizer(_config(learning_rate=lr, warmup_steps=0))
    assert flat.lr(0) == flat.lr(100) == np.float32(lr)


def test_clip_matches_optax_at_and_above_the_threshold():
    rng = np.random.RandomState(4)
    g = {"a": rng.randn(7).astype(np.float32), "b": rng.randn(3, 2).astype(np.float32)}
    norm = float(np.sqrt(sum((v ** 2).sum() for v in g.values())))
    for max_norm in (norm * 2, norm / 3):
        clip = optax.clip_by_global_norm(max_norm)
        ref, _ = clip.update({k: jnp.asarray(v) for k, v in g.items()},
                             clip.init(g))
        config = _config(grad_clip_norm=max_norm, learning_rate=1.0,
                         warmup_steps=0)
        opt = T.make_optimizer(config)
        params = {k: torch.zeros(v.shape) for k, v in g.items()}
        state = opt.init(params)
        got = opt.update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                         state)
        np.testing.assert_allclose(float(got), norm, rtol=1e-6)
        for k in g:  # Adam's first moment is 0.1 * the clipped gradient
            np.testing.assert_allclose(state["mu"][k].numpy(),
                                       0.1 * np.asarray(ref[k]), rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_updates_match_the_jax_optimizer(weight_decay):
    """Four updates of the port's optimizer against the JAX package's own
    ``make_optimizer`` chain (clip, Adam(W), warmup LR) on the same
    gradients, some of them above the clip threshold."""
    rng = np.random.RandomState(6)
    config = _config(learning_rate=1e-2, warmup_steps=2,
                     weight_decay=weight_decay, grad_clip_norm=3.0)
    init = {"a": rng.randn(5).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}
    tx = jts.make_optimizer(config)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    opt = T.make_optimizer(config)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = opt.init(tp)
    for scale in (0.5, 4.0, 1.0, 2.0):
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in init.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert state["count"] == 4


def test_hybrid_loss_matches_jax():
    rng = np.random.RandomState(5)
    ctc = rng.rand(4).astype(np.float32) * 30
    att = rng.rand(4).astype(np.float32) * 20
    lens = np.array([5, 0, 3, 9], np.int32)
    for alpha in (1.0, 0.3):
        ref = jax_hybrid_loss(jnp.asarray(ctc), jnp.asarray(att),
                              jnp.asarray(lens), alpha, jnp.asarray(3))
        got = hybrid_loss(torch.from_numpy(ctc), torch.from_numpy(att),
                          torch.from_numpy(lens), alpha, torch.tensor(3))
        for k in ("loss", "loss_ctc", "loss_att"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adadelta"])
def test_unported_optimizers_raise(optimizer):
    """SGD and Adadelta raised until the port ran them; now three train
    steps of each match the JAX step with that optimizer: the losses, the
    first gradients, and the parameters after the updates (within 1% of
    the largest move; Adadelta's first steps, like Adam's, move an entry
    whose gradient is near 0 by the fraction its rounding gives it)."""
    train = ({"learning_rate": 1.0, "warmup_steps": 0}
             if optimizer == "adadelta" else {})
    r = _three_steps(_config(optimizer=optimizer, **train), _batch())
    for m, jm in zip(r["port_metrics"], r["jax_metrics"]):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
    for k, g in r["port_grads"].items():
        np.testing.assert_allclose(g, r["jax_grads"][k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    moved = max(np.abs(v - r["init"][k]).max()
                for k, v in r["jax_params"][2].items())
    assert moved > 0
    for k, v in r["port_params"][2].items():
        np.testing.assert_allclose(v, r["jax_params"][2][k], rtol=0,
                                   atol=0.01 * moved + 1e-8, err_msg=k)
    assert r["opt"].kind == optimizer


def test_hybrid_training_raises_naming_k4():
    """Stacked decoder layers raised, naming K4, until the port ran them:
    now a hybrid step with dec_layers=2 (dot and loc) builds the stacked
    decoder, takes the JAX route (plain torch, never K4's) and trains."""
    config = copy.deepcopy(_hybrid_config())
    assert build_model(config, VOCAB, train=True).use_decoder
    assert not build_model(_config(), VOCAB, train=True).use_decoder
    for att_type in ("dot", "loc"):
        stacked = copy.deepcopy(config)
        stacked.model.att_type, stacked.model.dec_layers = att_type, 2
        stacked.model.loc_conv_channels = 4
        stacked.model.loc_conv_width = 7
        model = build_model(stacked, VOCAB, train=True)
        assert model.decoder.cell1_wx.shape == (8, 32)
        opt = T.make_optimizer(stacked)
        state = T.create_train_state(stacked, model, opt)
        calls = LD.las_decoder_fwd_plain.calls, LD.las_decoder_bwd_plain.calls
        m = T.make_train_step(model, stacked, opt)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()})
        assert (LD.las_decoder_fwd_plain.calls,
                LD.las_decoder_bwd_plain.calls) == calls
        assert float(m["loss_att"]) > 0 and state.step == 1
        assert float(model.decoder.cell1_wh.grad.abs().max()) > 0


def test_hybrid_loss_and_metrics_match(hybrid_runs):
    m, jm = hybrid_runs["port_metrics"][0], hybrid_runs["jax_metrics"][0]
    np.testing.assert_allclose(m["loss"], hybrid_runs["jax_loss"], rtol=1e-5)
    for k in ("loss", "loss_ctc", "loss_att", "att_acc", "num_real"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert m["loss_att"] > 0 and m["num_real"] == 3


def test_hybrid_every_gradient_leaf_matches(hybrid_runs):
    grads = hybrid_runs["port_grads"]
    assert set(grads) == set(hybrid_runs["jax_grads"])
    assert any(k.startswith("decoder.") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, hybrid_runs["jax_grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_hybrid_grad_norm_matches(hybrid_runs):
    for m, jm in zip(hybrid_runs["port_metrics"], hybrid_runs["jax_metrics"]):
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("n", [1, 3])
def test_hybrid_parameters_after_adam_match(hybrid_runs, n):
    opt = hybrid_runs["opt"]
    atol = 0.01 * sum(opt.lr(i) for i in range(n)) + 1e-7
    for k, v in hybrid_runs["port_params"][n - 1].items():
        np.testing.assert_allclose(v, hybrid_runs["jax_params"][n - 1][k],
                                   rtol=0, atol=atol, err_msg=k)


def test_scheduled_sampling_coins():
    """The coins: Bernoulli(ss_prob) per (step, row), step 0 never; no
    draw at all when the probability is 0."""
    config = _hybrid_config()
    config.loss.scheduled_sampling = 0.1
    gen = torch.Generator().manual_seed(3)
    coins = draw_coins(config, 0, 64, 99, gen, torch.device("cpu"))
    assert coins.shape == (100, 64) and coins.dtype == torch.bool
    assert not coins[0].any()
    np.testing.assert_allclose(coins[1:].float().mean().item(), 0.1, atol=0.015)
    config.loss.scheduled_sampling = 0.0
    state = gen.get_state()
    assert draw_coins(config, 0, 64, 99, gen, torch.device("cpu")) is None
    assert torch.equal(gen.get_state(), state)


def test_scheduled_sampling_ramp_matches_jax():
    """``loss.scheduled_sampling_warmup_steps``: the JAX step's
    ``ss * min(step / warmup, 1)`` in f32 (training/train_step.py:208-214
    there)."""
    config = _hybrid_config()
    config.loss.scheduled_sampling, warmup = 0.1, 7
    config.loss.scheduled_sampling_warmup_steps = warmup
    for step in (0, 1, 3, 6, 7, 20):
        ref = 0.1 * jnp.minimum(jnp.asarray(step, jnp.int32).astype(jnp.float32)
                                / float(warmup), 1.0)
        assert ss_prob(config, step) == float(ref), step
    config.loss.scheduled_sampling_warmup_steps = 0
    assert ss_prob(config, 0) == 0.1


def test_hybrid_step_with_scheduled_sampling_runs():
    """With scheduled sampling on, the step draws the coins after
    SpecAugment's masks and trains on the fed-back tokens."""
    config = _hybrid_config()
    config.loss.scheduled_sampling = 1.0
    model = build_model(config, VOCAB, train=True)
    opt = T.make_optimizer(config)
    state = T.create_train_state(config, model, opt)
    fn = T.make_train_step(model, config, opt)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pad_row=True).items()}
    before = state.generator.get_state()
    m = fn(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["loss_att"]) > 0
    assert not torch.equal(state.generator.get_state(), before)
    assert state.step == 1


def test_encoder_dropout_in_training_raises():
    """Encoder dropout raised in training until the port ran it; now the
    JAX encoder's masks (``nn.Dropout`` after each layer, its key
    ``fold_in(dropout_rng, layer)``), reproduced here and fed to the port,
    give the JAX outputs (rtol/atol 1e-5, the encoder tests' tolerance);
    and the train step draws one [B, T_l, 2H] mask a layer, after
    SpecAugment and the coins."""
    config = _config()
    config.model.enc_dropout = 0.25
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 16, 80).astype(np.float32)
    lens = np.array([16, 9], np.int32)
    jmodel = jax_build_model(config, VOCAB)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                         jnp.asarray(lens))["params"]
    key = jax.random.PRNGKey(5)
    ref = jmodel.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(lens), train=True, dropout_rng=key)
    model = build_model(config, VOCAB, train=True)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)))
    frames = model.encoder.layer_frames(16)
    assert frames == [16, 8]
    masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, layer), 0.75, (2, t, 16))))
        for layer, t in enumerate(frames)]
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(lens),
                    drop_masks=masks)
        plain = model(torch.from_numpy(feats), torch.from_numpy(lens))
    for k in ("enc", "ctc_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert not torch.allclose(got["enc"], plain["enc"])
    gen = torch.Generator().manual_seed(1)
    drawn = T.draw_dropout(config, model, 2, 16, gen, torch.device("cpu"))
    assert [m.shape for m in drawn] == [(2, 16, 16), (2, 8, 16)]
    keep = float(torch.cat([m.flatten() for m in drawn]).float().mean())
    assert 0.6 < keep < 0.9
    config.model.enc_dropout = 0.0
    assert T.draw_dropout(config, model, 2, 16, gen, "cpu") is None


def test_loc_hybrid_loss_and_metrics_match(loc_runs):
    m, jm = loc_runs["port_metrics"][0], loc_runs["jax_metrics"][0]
    np.testing.assert_allclose(m["loss"], loc_runs["jax_loss"], rtol=1e-5)
    for k in ("loss", "loss_ctc", "loss_att", "att_acc", "num_real"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_loc_every_gradient_leaf_matches(loc_runs):
    """Every leaf, the location filter (through the band) and its
    projection among them."""
    grads = loc_runs["port_grads"]
    assert set(grads) == set(loc_runs["jax_grads"])
    assert {"decoder.loc_filter", "decoder.loc_proj"} <= set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, loc_runs["jax_grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert np.abs(grads["decoder.loc_filter"]).max() > 0


@pytest.mark.parametrize("n", [1, 3])
def test_loc_parameters_after_adam_match(loc_runs, n):
    """The loc parameters go through clip and Adam like every other leaf."""
    opt = loc_runs["opt"]
    atol = 0.01 * sum(opt.lr(i) for i in range(n)) + 1e-7
    for k, v in loc_runs["port_params"][n - 1].items():
        np.testing.assert_allclose(v, loc_runs["jax_params"][n - 1][k],
                                   rtol=0, atol=atol, err_msg=k)
    moved = np.abs(loc_runs["port_params"][n - 1]["decoder.loc_filter"]
                   - loc_runs["init"]["decoder.loc_filter"]).max()
    assert (moved > 0) == (n > 1)
