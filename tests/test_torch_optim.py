"""PyTorch port: the optimizer families, eps annealing, plateau
restore-best and early stopping against the JAX package on the CPU.

SGD (``optax.sgd``, momentum 0.9) and Adadelta
(``optax.inject_hyperparams(optax.adadelta)``) take three updates on
the same fed gradients as the JAX ``make_optimizer``'s chain (clip
included, with and without a warmup), parameter for parameter at rtol
1e-6 (both are the same f32 formulas); ``decay_opt_eps`` anneals the
eps in the state and floors it at the f32 tiny value; the annealed eps
goes through a checkpoint; a params-only restore reads a checkpoint of
any optimizer. The trainer's ``_plateau_anneal`` and early stopping run
on scripted dev WERs, as ``tests/test_adadelta.py`` and
``tests/test_accum.py`` script them for the JAX trainer; a
``profile_dir`` run writes a trace.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluon_e2e_asr_tpu.config import Config as JaxConfig
from gluon_e2e_asr_tpu.config import TrainConfig as JaxTrainConfig
from gluon_e2e_asr_tpu.training.train_step import decay_opt_eps as jax_decay
from gluon_e2e_asr_tpu.training.train_step import make_optimizer as jax_opt
from gluon_e2e_asr_tpu_torch.config import (
    Config, DataConfig, DecodeConfig, FrontendConfig, LossConfig,
    ModelConfig, TrainConfig)
from gluon_e2e_asr_tpu_torch.training import train_step as T
from gluon_e2e_asr_tpu_torch.training.checkpoint import (
    restore_train_checkpoint, save_train_checkpoint)
from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}


def _train(**kw):
    return dict(learning_rate=0.5, warmup_steps=2, grad_clip_norm=5.0,
                adadelta_eps=1e-4, **kw)


def _grads(seed, scale):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "adadelta", "adam"])
def test_three_updates_match_optax(optimizer, warmup):
    """The fourth gradient's norm exceeds the clip, so the clip acts."""
    kw = _train(optimizer=optimizer)
    kw["warmup_steps"] = warmup
    tx = jax_opt(JaxConfig(train=JaxTrainConfig(**kw)))
    opt = T.make_optimizer(Config(train=TrainConfig(**kw)))
    p0 = _grads(0, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = tx.init(jp), opt.init(tp)
    for i, scale in enumerate((0.3, 1.0, 4.0)):
        g = _grads(i + 1, scale)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert ts["count"] == 3 and ts["kind"] == ("adam" if optimizer == "adam"
                                               else optimizer)


def _adadelta(eps=1e-8):
    return T.make_optimizer(Config(train=TrainConfig(
        optimizer="adadelta", learning_rate=1.0, warmup_steps=0,
        adadelta_eps=eps)))


def test_decay_opt_eps_matches_jax_and_floors_at_tiny():
    opt = _adadelta()
    state = opt.init({"w": torch.ones(3)})
    jstate = jax_opt(JaxConfig(train=JaxTrainConfig(
        optimizer="adadelta", learning_rate=1.0, warmup_steps=0,
        adadelta_eps=1e-8))).init({"w": jnp.ones(3)})
    for _ in range(30):  # 1e-8 * 0.01^30 would underflow f32 by far
        state, old, new = T.decay_opt_eps(state, 0.01)
        jstate, jold, jnew = jax_decay(jstate, 0.01)
        assert (old, new) == (jold, jnew)
    assert new == float(np.finfo(np.float32).tiny) > 0.0
    same, old, new = T.decay_opt_eps(T.make_optimizer(Config()).init(
        {"w": torch.ones(2)}), 0.01)
    assert old is None and new is None and "eps" not in same


def test_annealed_eps_takes_a_smaller_first_step():
    opt = _adadelta()
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    annealed, _, _ = T.decay_opt_eps(state, 0.01)
    steps = []
    for s in (state, annealed):
        p = {"w": torch.ones(3)}
        opt.update(p, {"w": torch.ones(3)}, s)
        steps.append(float((p["w"] - 1).abs().max()))
    assert steps[1] < steps[0]


def test_annealed_eps_survives_a_checkpoint(tmp_path):
    opt = _adadelta()
    params = {"w": torch.arange(4.0)}
    state, _, new = T.decay_opt_eps(opt.init(params), 0.01)
    path = save_train_checkpoint(str(tmp_path), params, state, 7, {},
                                 generator=torch.Generator().get_state())
    back = restore_train_checkpoint(path, opt.init(params))
    assert back.opt_state["eps"] == new == pytest.approx(1e-10)
    assert back.step == 7


def test_params_only_restore_across_optimizers(tmp_path):
    """A checkpoint of an adadelta run restores whole only into an
    adadelta state; params_only takes its parameters and step into any."""
    params = {"w": torch.arange(4.0)}
    path = save_train_checkpoint(str(tmp_path), params,
                                 _adadelta().init(params), 7, {},
                                 generator=torch.Generator().get_state())
    adam = T.make_optimizer(Config()).init(params)
    with pytest.raises(ValueError, match="adadelta"):
        restore_train_checkpoint(path, adam)
    got = restore_train_checkpoint(path, adam, params_only=True)
    assert torch.equal(got.params["w"], params["w"]) and got.step == 7
    assert got.opt_state is None and got.generator is None


def _fake_trainer(train, workdir="/nonexistent"):
    """What ``Trainer._plateau_anneal`` reads of a trainer."""
    config = Config(train=TrainConfig(**train))
    events = []
    model = torch.nn.Linear(2, 2)
    opt = T.make_optimizer(config)
    fake = SimpleNamespace(
        config=config, workdir=workdir, model=model, device=torch.device("cpu"),
        world=SimpleNamespace(barrier=lambda: events.append("barrier")),
        state=SimpleNamespace(opt_state=opt.init(dict(model.named_parameters()))),
        logger=SimpleNamespace(log=events.append))
    return fake, events


def test_plateau_anneal_patience_gating():
    """eps_decay_patience=N anneals only at the end of each full window of
    no-best epochs (tests/test_adadelta.py's JAX check)."""
    fake, events = _fake_trainer(dict(optimizer="adadelta", learning_rate=1.0,
                                      warmup_steps=0, eps_decay=0.01,
                                      eps_decay_patience=3))
    for stale in (1, 2, 3, 4, 5, 6):
        fake._stale_epochs = stale
        Trainer._plateau_anneal(fake, epoch=stale)
    decays = [e for e in events if isinstance(e, dict)
              and e["event"] == "eps_decay"]
    assert [e["epoch"] for e in decays] == [3, 6]
    assert decays[1]["eps_new"] == pytest.approx(1e-12)
    assert fake.state.opt_state["eps"] == decays[1]["eps_new"]


def test_plateau_eps_decay_with_adam_is_skipped():
    fake, events = _fake_trainer(dict(eps_decay=0.5))
    fake._stale_epochs = 1
    Trainer._plateau_anneal(fake, epoch=4)
    assert events[-1]["event"] == "eps_decay_skipped"
    assert events[-1]["restored_best"] is False


def test_plateau_restore_best_loads_best_after_a_barrier(tmp_path):
    best = {"weight": torch.full((2, 2), 3.0), "bias": torch.ones(2)}
    ckpts = tmp_path / "ck"
    save_train_checkpoint(str(ckpts), best, {}, 4, {}, is_best=True,
                          generator=torch.Generator().get_state())
    fake, events = _fake_trainer(
        dict(optimizer="adadelta", learning_rate=1.0, warmup_steps=0,
             eps_decay=0.1, plateau_restore_best=True, ckpt_dir="ck"),
        workdir=str(tmp_path))
    fake._stale_epochs = 1
    Trainer._plateau_anneal(fake, epoch=2)
    assert events[0] == "barrier"
    assert events[-1]["event"] == "eps_decay"
    assert events[-1]["restored_best"] is True
    for k, v in fake.model.state_dict().items():
        assert torch.equal(v, best[k])


def _tiny(tmp_path, **train):
    return Config(
        data=DataConfig(dataset="synthetic", synth_num_train=8,
                        synth_num_dev=4, synth_max_tokens=5, batch_size=4,
                        bucket_bounds_sec=(1.5,), prefetch_depth=0),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=8, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        decode=DecodeConfig(method="greedy"),
        train=TrainConfig(**dict(dict(seed=0, warmup_steps=2, ckpt_dir="ck",
                                      log_every_steps=1), **train)))


def _events(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_early_stop_patience(tmp_path, monkeypatch):
    """Improves at epochs 0 and 1, stale from 2 on: patience 2 stops after
    epoch 3 (tests/test_accum.py's JAX check)."""
    tr = Trainer(_tiny(tmp_path, num_epochs=10, early_stop_patience=2),
                 workdir=str(tmp_path))
    script = iter([0.9, 0.5, 0.5, 0.6, 0.4, 0.4, 0.4])
    monkeypatch.setattr(tr, "evaluate",
                        lambda: {"dev_wer": next(script), "dev_cer": 0.0})
    final = tr.train()
    assert final["epoch"] == 3 and tr.best_wer == 0.5
    stops = [e for e in _events(tmp_path) if e["event"] == "early_stop"]
    assert stops == [dict(stops[0], epoch=3, best_wer=0.5, patience=2)]


def test_trainer_plateau_anneal_and_restore(tmp_path, monkeypatch):
    """adadelta with eps_decay and plateau_restore_best on scripted WERs:
    each stale epoch anneals, the parameters equal best.pt's after the
    restore, and the checkpoint carries the annealed eps."""
    tr = Trainer(_tiny(tmp_path, num_epochs=3, optimizer="adadelta",
                       learning_rate=1.0, warmup_steps=0, eps_decay=0.01,
                       plateau_restore_best=True), workdir=str(tmp_path))
    script = iter([0.5, 0.7, 0.6])
    monkeypatch.setattr(tr, "evaluate",
                        lambda: {"dev_wer": next(script), "dev_cer": 0.0})
    tr.train()
    decays = [e for e in _events(tmp_path) if e["event"] == "eps_decay"]
    assert [e["epoch"] for e in decays] == [1, 2]
    assert all(e["restored_best"] for e in decays)
    ck = tmp_path / "ck"
    assert os.readlink(ck / "best.pt") == "ckpt_2.pt"
    best = restore_train_checkpoint(str(ck / "best.pt"), params_only=True)
    last = restore_train_checkpoint(str(ck / "ckpt_6.pt"), tr.state.opt_state)
    for k, v in last.params.items():
        assert torch.equal(v, best.params[k]), k
    assert last.opt_state["eps"] == pytest.approx(1e-8 * 0.01 ** 2, rel=1e-5)


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    tr = Trainer(_tiny(tmp_path, num_epochs=1, profile_dir=str(prof),
                       profile_start_step=0, profile_num_steps=1),
                 workdir=str(tmp_path))
    tr.train()
    traces = list(prof.glob("trace_0-1_rank0.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    lines = [e for e in _events(tmp_path) if e["event"] == "profile"]
    assert lines[0]["first_step"] == 0 and lines[0]["last_step"] == 1
