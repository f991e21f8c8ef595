"""PyTorch port: one CTC-only training step against the JAX package's
``make_train_step`` on the CPU.

A tiny CTC-only config (``loss.mtl_alpha: 1.0``), f32, SpecAugment masks
0 (the deterministic setup of ``__graft_entry__.py``), the JAX
parameters bridged into the port and a fresh optimizer state on both
sides. The JAX encoder runs ``lstm_impl: pallas`` (``bilstm_fused`` and
the CTC kernels in interpret mode); the port runs its plain versions.
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
from gluon_e2e_asr_tpu_torch.ops.losses import hybrid_loss
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


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    B, S, L = 3, 4800, 5
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    audio_len = np.array([4800, 3600, 2400], np.int32)
    labels = rng.randint(1, VOCAB, size=(B, L)).astype(np.int32)
    label_len = np.array([5, 3, 2], np.int32)
    labels[1, 3:] = labels[2, 2:] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels,
            "label_len": label_len}


def _jax_setup(config, batch):
    model = jax_build_model(config, VOCAB)
    assert not model.use_decoder
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


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps and three port steps from the same parameters."""
    config = _config()
    batch = _batch()
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.make_optimizer(_config(optimizer=optimizer))


def test_hybrid_training_raises_naming_k4():
    config = copy.deepcopy(_config())
    config.loss.mtl_alpha = 0.3
    with pytest.raises(NotImplementedError, match="K4"):
        build_model(config, VOCAB, train=True)
    build_model(config, VOCAB)  # the decoder-free model still serves


def test_encoder_dropout_in_training_raises():
    config = _config()
    config.model.enc_dropout = 0.1
    model = build_model(config, VOCAB, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(torch.zeros(1, 8, 80), torch.tensor([8]), train=True)
