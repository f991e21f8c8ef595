"""PyTorch port: gradient accumulation (``train.accum_grad_steps``)
against the JAX package on the CPU.

The setup of ``tests/test_accum.py`` (8 rows, add attention, 2 layers
of 32 units, no SpecAugment, dropout or scheduled sampling, so the
generator's advance per micro-batch cannot change the math), the JAX
parameters bridged into the port. Two micro-batches (the halves) through
``make_grad_step`` and one ``Accumulator`` update against one step on
the whole batch in the port (the contract: the same update, up to the
order of the sums), and against the JAX ``make_grad_step`` +
``accumulate_grads`` + ``make_apply_step``: the combined gradient and
the parameters after the update at rtol 1e-4 / atol 1e-6, as
``tests/test_accum.py`` holds the JAX paths to each other. An epoch of 5
batches at accum_grad_steps=2 takes 3 updates (the last group flushed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu import config as JC
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch import config as PC
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.manifest import build_synthetic_manifest
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.training import train_step as T
from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

B = 8


def _config(C, **train):
    return C.Config(
        data=C.DataConfig(dataset="synthetic", synth_num_train=B,
                          synth_max_tokens=5, batch_size=B,
                          bucket_bounds_sec=(1.5,)),
        frontend=C.FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=C.ModelConfig(enc_hidden=32, enc_layers=2, enc_subsample=(1, 2),
                            dec_hidden=32, dec_embed=16, att_dim=16,
                            att_type="add"),
        loss=C.LossConfig(mtl_alpha=0.3),
        train=C.TrainConfig(seed=0, **train))


def _batch():
    tok = CharTokenizer()
    utts = build_synthetic_manifest(B, seed=0, max_tokens=5)
    specs = make_bucket_specs((1.5,), 16000, B, 16)
    loader = DataLoader(utts, BucketSampler(utts, specs, 16000, seed=0,
                                            shuffle=False), tok)
    b = next(iter(loader.epoch(0)))
    return {"audio": b.audio, "audio_len": b.audio_len, "labels": b.labels,
            "label_len": b.label_len}


def _halves(batch):
    return [{k: v[rows] for k, v in batch.items()}
            for rows in (slice(0, B // 2), slice(B // 2, None))]


def _port(params, **train):
    """A port model with ``params``, its optimizer and a fresh state."""
    config = _config(PC, **train)
    tok = CharTokenizer()
    model = build_model(config, tok.vocab_size, train=True, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    model.load_state_dict(params)
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0, opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(0))
    return config, model, opt, state


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX accumulated update (two micro-batches) from its init, with
    warmup 0 so the update moves the parameters."""
    config = _config(JC, warmup_steps=0)
    batch = _batch()
    tok = CharTokenizer()
    model = jax_build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = jts.make_optimizer(config)
    state = jts.create_train_state(config, model, tx, batch)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    grad_step, apply_step = jts.make_grad_step(model, config), jts.make_apply_step(tx)
    b1, b2 = [{k: jnp.asarray(v) for k, v in h.items()}
              for h in _halves(batch)]
    state, g1, m1 = grad_step(state, b1)
    state, g2, m2 = grad_step(state, b2)
    total = m1["num_real"] + m2["num_real"]
    acc = jts.accumulate_grads(g1, g2)
    mean = params_from_jax(jax.tree_util.tree_map(
        lambda g: np.asarray(g) / float(total), acc))
    new, grad_norm = apply_step(state, acc, total)
    return {"params": params, "batch": batch, "grads": mean,
            "new_params": params_from_jax(jax.tree_util.tree_map(
                np.asarray, new.params)),
            "grad_norm": float(grad_norm), "step": int(new.step),
            "losses": [float(m["loss"]) for m in (m1, m2)]}


def _accumulate(params, batch, **train):
    config, model, opt, state = _port(params, **train)
    grad_fn, acc = T.make_grad_step(model, config), T.Accumulator(model, opt)
    losses = []
    for half in _halves(batch):
        grads, m = grad_fn(state, {k: torch.from_numpy(v) for k, v in half.items()})
        losses.append(float(m["loss"]))
        acc.add(grads, m)
    mean = {k: g / acc.n for k, g in acc.grads.items()}
    m = acc.apply(state)
    return model, state, mean, m, losses


def test_two_micro_batches_match_one_combined_batch(jax_runs):
    params, batch = jax_runs["params"], jax_runs["batch"]
    config, model, opt, state = _port(params, warmup_steps=0)
    m_big = T.make_train_step(model, config, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    big = {k: p.grad for k, p in model.named_parameters()}
    acc_model, acc_state, mean, m, losses = _accumulate(params, batch,
                                                        warmup_steps=0)
    assert acc_state.step == state.step == 1
    assert float(m["num_real"]) == B
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_big["grad_norm"]),
                               rtol=1e-4)
    # the micro-batches' losses, weighted by their rows, are the whole one's
    np.testing.assert_allclose(float(m["loss"]), float(m_big["loss"]),
                               rtol=1e-5)
    for k, g in big.items():
        np.testing.assert_allclose(mean[k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(acc_model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_accumulation_matches_jax_grad_and_apply_steps(jax_runs):
    model, state, mean, m, losses = _accumulate(
        jax_runs["params"], jax_runs["batch"], warmup_steps=0)
    np.testing.assert_allclose(losses, jax_runs["losses"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jax_runs["grad_norm"],
                               rtol=1e-4)
    assert state.step == jax_runs["step"] == 1
    for k, g in jax_runs["grads"].items():
        g = g.numpy()
        np.testing.assert_allclose(mean[k].numpy(), g, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # Adam's first update is lr * g / (|g| + eps): compare where the
    # gradient is firm (above the gradient atol), as the train-step tests do
    for k, v in model.state_dict().items():
        ref, g = jax_runs["new_params"][k].numpy(), jax_runs["grads"][k].numpy()
        firm = np.abs(g) > 1e-6
        np.testing.assert_allclose(v.numpy()[firm], ref[firm], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_an_epoch_counts_updates_and_flushes_the_last_group(tmp_path):
    """5 batches an epoch at accum_grad_steps=2: 2 full groups and the
    remainder, 3 updates (the JAX trainer's count); none left open."""
    config = _config(PC, num_epochs=1, warmup_steps=2, accum_grad_steps=2,
                     log_every_steps=1, ckpt_dir="ck")
    config.data.synth_num_train, config.data.batch_size = 10, 2
    config.data.prefetch_depth = 0
    config.decode.method = "greedy"
    tr = Trainer(config, workdir=str(tmp_path))
    tr.train()
    assert tr.state.step == 3 and tr.state.opt_state["count"] == 3
    assert tr._acc.micro == 0 and tr._acc.grads is None
