"""PyTorch port: the five milestone configs, the two English
milestone-5 variants and ``vgg_blstm.yaml`` (the VGG2L encoder), against
the JAX package on the CPU.

The counterpart of ``tests/test_milestone_configs.py``. Every config
loads in the port as in the JAX package and passes the trainer's checks
(``train.dp: true`` included). Each then takes 2 training steps on the
port's plain versions against the JAX ``make_train_step`` (Pallas kernels
in interpret mode where the config asks for them), from the same
parameters, fed the same draws: SpecAugment's masks and the
scheduled-sampling coins as the JAX step draws them from its key, handed
to the port's step in place of its own. The JAX step's gradients are read
back from its Adam first moments (and its clip); configs whose step is
the same program (milestones 4 and 5 and ``english_m5``) share one
compiled JAX step. The configs are cut to test
widths and nothing else: ``enc_hidden``, ``dec_hidden`` 256 -> 8,
``dec_embed`` 256 -> 6, ``att_dim`` 320 -> 8, the location filter's
``loc_conv_channels`` 10 -> 4 and ``loc_conv_width`` 100 -> 7 (VGG2L's
channels stay as shipped: its convs are cheap at this size; vgg_blstm's
bf16 runs in f32 here: in bf16 each conv bias's gradient is a sum of
thousands of bf16 values that XLA on the CPU and PyTorch round in
different orders, 4% of the largest such gradient apart, while the loss
agrees to 2e-7; ``tests/test_torch_vgg.py`` holds the bf16 forward and
phase 6d of ``chip_smoke.py`` the bf16 training on the card); a batch of
3 utterances of up to 0.3 s and a pad row (labels from the config's
vocabulary) in place of the 2.0 / 4.0 s buckets of 16. Layers,
subsampling, frontend, attention type, losses, LR schedule, dtypes and
``lstm_impl`` stay as shipped.

Tolerances (``tests/test_torch_train_step.py``): the loss rtol 1e-5;
gradients and the gradient norm rtol 1e-4 / atol 1e-5; the parameters
after the two updates (the first at LR 0 in the warmup) within 1% of
the LR where both steps' gradients are firm (above that atol), within
the update's size elsewhere.

Milestone 3's dev evaluation, the attention-only beam (K=8,
``ctc_weight`` 0), runs through the trainer without touching the CTC
prefix scoring or the CTC loss.
"""

import dataclasses
import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import load_config as jax_load_config
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.config import load_config
from gluon_e2e_asr_tpu_torch.data.tokenizer import build_tokenizer
from gluon_e2e_asr_tpu_torch.decoding import beam as B
from gluon_e2e_asr_tpu_torch.frontend.features import SpecAugDraws, num_frames
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.training import train_step as T
from gluon_e2e_asr_tpu_torch.training import trainer as TR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MILESTONES = sorted(glob.glob(os.path.join(REPO, "configs", "milestone*.yaml")))
CONFIGS = MILESTONES + [os.path.join(REPO, "configs", f"{n}.yaml")
                        for n in ("english_m5", "english_m5_bpe", "vgg_blstm")]
IDS = [os.path.basename(p)[:-5] for p in CONFIGS]
STEPS = 2


def _tokenizer(config):
    return build_tokenizer(config, (u.text for u in TR.build_datasets(config)[0]))


def test_five_milestone_configs_exist():
    assert len(MILESTONES) == 5, MILESTONES


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_in_the_port(path):
    """The port reads each config as the JAX package does, the trainer
    takes every option it sets, and the model builds at full width."""
    config = load_config(path)
    assert dataclasses.asdict(config) == dataclasses.asdict(
        jax_load_config(path))
    if "milestone3" in path:
        assert config.loss.mtl_alpha == 0.0 and config.decode.ctc_weight == 0.0
    if "milestone4" in path:
        assert config.train.dp and 0 < config.loss.mtl_alpha < 1
    tok = _tokenizer(config)
    model = build_model(config, tok.vocab_size, train=True, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    assert model.use_decoder == (config.loss.mtl_alpha < 1.0)
    assert model.encoder.cfg.enc_hidden == config.model.enc_hidden
    if "vgg" in path:  # VGG2L's 128 channels of 20 mel bins feed layer 0
        assert model.encoder.l0_in_w.shape == (2560, 8 * 320)


def _cut(config):
    mc = config.model
    mc.enc_hidden = mc.dec_hidden = 8
    mc.dec_embed, mc.att_dim = 6, 8
    mc.loc_conv_channels, mc.loc_conv_width = 4, 7
    if mc.enc_type == "vggblstm":  # bf16 -> f32: see the module docstring
        mc.compute_dtype = "float32"
    return config


def _batch(vocab):
    rng = np.random.RandomState(0)
    Bn, S, L = 3, 4800, 5
    audio = (rng.randn(Bn + 1, S) * 0.1).astype(np.float32)
    audio[Bn] = 0.0
    audio_len = np.array([4800, 3600, 2400, 0], np.int32)
    labels = rng.randint(4, vocab, size=(Bn + 1, L)).astype(np.int32)
    label_len = np.array([5, 3, 2, 0], np.int32)
    labels[np.arange(L)[None, :] >= label_len[:, None]] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels,
            "label_len": label_len}


def _jax_draws(key, fc, n, frames):
    """SpecAugment's draws of the JAX ``spec_augment`` under ``key``."""
    keys = jax.random.split(key, 4)
    nf, nt = fc.specaug_freq_masks, fc.specaug_time_masks
    fw = jax.random.randint(keys[0], (n, nf, 1), 0, fc.specaug_freq_width + 1)
    fs = jax.random.randint(keys[1], (n, nf, 1), 0,
                            jnp.maximum(fc.n_mels - fw + 1, 1))
    tw = jax.random.randint(keys[2], (n, nt, 1), 0, fc.specaug_time_width + 1)
    ts = jax.random.randint(keys[3], (n, nt, 1), 0, frames)
    return SpecAugDraws(*(torch.from_numpy(np.asarray(d).astype(np.int64))
                          for d in (fw, fs, tw, ts)))


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _adam_mu(opt_state):
    """The first moment of the optax Adam state inside ``opt_state``."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return _flat(node.mu)
    raise AssertionError("no Adam state")


def _step_grads(mu, mu_prev, norm, clip):
    """The gradients a JAX step took, from its Adam first moments:
    mu = 0.1 * g_clipped + 0.9 * mu_prev in f32, g_clipped = g * clip /
    norm where norm >= clip."""
    scale = norm / clip if clip > 0 and norm >= clip else 1.0
    out = {}
    for k, m in mu.items():
        prev = np.float32(0.9) * mu_prev[k] if mu_prev else 0.0
        out[k] = ((m.astype(np.float64) - prev) / np.float32(0.1)) * scale
    return out


# One JAX train step per model, loss, frontend and optimizer setting and
# vocabulary: milestone 5 and english_m5 share milestone 4's.
_JAX_STEPS = {}


def _jax_step(jconfig, V, sos, eos):
    tc = jconfig.train
    key = repr((dataclasses.asdict(jconfig.model),
                dataclasses.asdict(jconfig.loss),
                dataclasses.asdict(jconfig.frontend),
                tc.optimizer, tc.learning_rate, tc.warmup_steps,
                tc.grad_clip_norm, tc.weight_decay, V, sos, eos))
    if key not in _JAX_STEPS:
        jmodel = jax_build_model(jconfig, V, sos, eos)
        tx = jts.make_optimizer(jconfig)
        _JAX_STEPS[key] = (jmodel, tx, jts.make_train_step(jmodel, jconfig, tx))
    return _JAX_STEPS[key]


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def steps(request):
    config = _cut(load_config(request.param))
    jconfig = _cut(jax_load_config(request.param))
    tok = _tokenizer(config)
    V = tok.vocab_size
    batch = _batch(V)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, tx, step = _jax_step(jconfig, V, tok.sos_id, tok.eos_id)
    st = jts.create_train_state(jconfig, jmodel, tx, batch)
    init = _flat(st.params)
    fc = config.frontend
    frames = num_frames(batch["audio"].shape[1], fc.win_length, fc.hop_length)
    L = batch["labels"].shape[1] + 1
    jax_runs, draws, mu = [], [], None
    for _ in range(STEPS):
        # The step's keys, as make_train_step splits them.
        _, step_rng = jax.random.split(st.rng)
        k_spec, k_ss, _ = jax.random.split(step_rng, 3)
        p_ss = T.ss_prob(config, int(st.step))
        coins = None
        if config.loss.mtl_alpha < 1.0 and p_ss > 0.0:
            c = np.array(jax.random.bernoulli(k_ss, p_ss, (L, len(batch["audio"]))))
            c[0] = False
            coins = torch.from_numpy(c)
        draws.append((_jax_draws(k_spec, fc, len(batch["audio"]), frames), coins))
        st, m = step(st, jb)
        m = {k: float(v) for k, v in m.items()}
        mu_prev, mu = mu, _adam_mu(st.opt_state)
        jax_runs.append({"metrics": m, "params": _flat(st.params),
                         "grads": _step_grads(mu, mu_prev, m["grad_norm"],
                                              jconfig.train.grad_clip_norm)})

    model = build_model(config, V, train=True, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0, opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(0))
    fn = T.make_train_step(model, config, opt)
    port_runs = []
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(STEPS):
        spec, coins = draws[i]
        with mock.patch.object(T, "draw_spec_augment", lambda *a: spec), \
                mock.patch.object(T, "draw_coins", lambda *a: coins):
            m = fn(state, tb)
        port_runs.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: (p.grad.numpy().copy() if p.grad is not None
                          else np.zeros(tuple(p.shape), np.float32))
                      for k, p in model.named_parameters()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}})
    return {"config": config, "jax": jax_runs, "port": port_runs,
            "init": init, "opt": opt, "coins": [d[1] for d in draws]}


def test_losses_match_jax(steps):
    for p, j in zip(steps["port"], steps["jax"]):
        np.testing.assert_allclose(p["metrics"]["loss"], j["metrics"]["loss"],
                                   rtol=1e-5)
        for k in ("loss_ctc", "loss_att", "att_acc", "num_real"):
            np.testing.assert_allclose(p["metrics"][k], j["metrics"][k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    config = steps["config"]
    if config.loss.mtl_alpha == 0.0:  # milestone 3: no CTC loss at all
        assert all(p["metrics"]["loss_ctc"] == 0.0 for p in steps["port"])
    if config.loss.mtl_alpha < 1.0:
        assert all(p["metrics"]["loss_att"] > 0 for p in steps["port"])
        # the coins were drawn (scheduled sampling 0.1, no ramp)
        assert all(c is not None for c in steps["coins"])


def test_every_gradient_matches_jax(steps):
    for p, j in zip(steps["port"], steps["jax"]):
        assert set(p["grads"]) == set(j["grads"])
        for k, g in p["grads"].items():
            np.testing.assert_allclose(g, j["grads"][k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(p["metrics"]["grad_norm"],
                                   j["metrics"]["grad_norm"], rtol=1e-4)


def test_parameters_after_two_steps_match_jax(steps):
    opt = steps["opt"]
    lr = sum(opt.lr(i) for i in range(STEPS))
    assert opt.lr(0) == 0.0 < lr
    port, jax_ = steps["port"][-1]["params"], steps["jax"][-1]["params"]
    moved = max(np.abs(v - steps["init"][k]).max() for k, v in port.items())
    assert moved > 0
    for k, v in port.items():
        firm = np.ones(v.shape, bool)
        for j in steps["jax"]:
            firm &= np.abs(j["grads"][k]) > 1e-5
        np.testing.assert_allclose(v[firm], jax_[k][firm], rtol=0,
                                   atol=0.01 * lr + 1e-7, err_msg=k)
        np.testing.assert_allclose(v, jax_[k], rtol=0, atol=2 * lr + 1e-7,
                                   err_msg=k)


def test_milestone3_beam_dev_evaluation(tmp_path):
    """Milestone 3 as shipped, cut to a tiny run: mtl_alpha 0 and the
    attention-only beam (K=8, ctc_weight 0) as the epoch's dev evaluation
    (the counterpart of ``test_trainer_beam_eval_path``). Neither the CTC
    loss nor the beam's CTC prefix scoring may run."""
    config = _cut(load_config(os.path.join(REPO, "configs",
                                           "milestone3_las.yaml")))
    dc = config.data
    dc.synth_num_train, dc.synth_num_dev, dc.synth_max_tokens = 8, 4, 4
    dc.batch_size, dc.bucket_bounds_sec = 8, (1.5,)
    config.model.enc_layers, config.model.enc_subsample = 1, (2,)
    config.train.num_epochs = 1
    config.train.ckpt_dir = str(tmp_path / "ck")
    config.train.metrics_path = str(tmp_path / "m.jsonl")
    assert (config.decode.method, config.decode.beam_size,
            config.decode.ctc_weight) == ("beam", 8, 0.0)

    def refuse(*a, **k):
        raise AssertionError("a CTC path ran at mtl_alpha = ctc_weight = 0")

    with mock.patch.object(T, "ctc_loss", refuse), \
            mock.patch.object(B, "_ctc_extension_scores", refuse):
        t = TR.Trainer(config, workdir=str(tmp_path))
        assert t.greedy is None and t._beam is not None
        final = t.train()
    assert "dev_wer" in final and t.state.step == 1
