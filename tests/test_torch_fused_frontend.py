"""PyTorch port: the fused frontend (``frontend.impl: pallas`` and
``pallas_regrid``, ``frontend/fused.py``) on the CPU, where both run
their plain versions, against the JAX package's kernels K5
(``compute_features_pallas``) and K6 (``compute_features_pallas_regrid``)
in interpret mode.

Tolerance: the JAX suite's for this pair, rtol 1e-3 / atol 2e-3
(tests/test_pallas_frontend.py: log-mel features through two
implementations of f32 products). Masked cells are exactly 0 on both
sides. In training the JAX interpret path applies
``features.spec_augment`` with its key, and the port is fed the draws that
key gives (``_jax_draws``, as in tests/test_torch_specaug.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import FrontendConfig as JaxFrontendConfig
from gluon_e2e_asr_tpu.frontend import features as jf
from gluon_e2e_asr_tpu.frontend import pallas_frontend as jp
from gluon_e2e_asr_tpu_torch.config import FrontendConfig
from gluon_e2e_asr_tpu_torch.frontend import features as tf
from gluon_e2e_asr_tpu_torch.frontend import fused

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=2e-3)
IMPLS = {"pallas": (fused.compute_features_pallas, jp.compute_features_pallas),
         "pallas_regrid": (fused.compute_features_pallas_regrid,
                           jp.compute_features_pallas_regrid)}
STATS = (np.full((80,), -5.0, np.float32), np.full((80,), 3.0, np.float32))


def _batch(B=2, S=32000, seed=0):
    """tests/test_pallas_frontend.py's batch: tones plus a little noise,
    the rows 0.2 s shorter each."""
    rng = np.random.RandomState(seed)
    t = np.arange(S) / 16000.0
    audio = np.stack([
        (np.sin(2 * np.pi * (200 + 150 * b) * t) * 0.5).astype(np.float32)
        for b in range(B)])
    audio += 0.01 * rng.randn(B, S).astype(np.float32)
    lens = np.array([S] + [S - 3200 * b for b in range(1, B)], np.int32)
    return audio, lens


def _jax_draws(key, B, frames, cfg):
    """The draws of the JAX spec_augment under ``key``, as SpecAugDraws."""
    keys = jax.random.split(key, 4)
    nf, nt = cfg.specaug_freq_masks, cfg.specaug_time_masks
    fw = jax.random.randint(keys[0], (B, nf, 1), 0, cfg.specaug_freq_width + 1)
    fs = jax.random.randint(keys[1], (B, nf, 1), 0,
                            jnp.maximum(cfg.n_mels - fw + 1, 1))
    tw = jax.random.randint(keys[2], (B, nt, 1), 0, cfg.specaug_time_width + 1)
    ts = jax.random.randint(keys[3], (B, nt, 1), 0, frames)
    return tf.SpecAugDraws(*(torch.from_numpy(np.asarray(d).astype(np.int64))
                             for d in (fw, fs, tw, ts)))


def _compare(impl, cmvn, audio, lens, train=False, key=None, **cfg_kw):
    port_fn, jax_fn = IMPLS[impl]
    stats = STATS if cmvn == "global" else None
    jcfg = JaxFrontendConfig(cmvn=cmvn, **cfg_kw)
    ref, ref_len = jax_fn(jcfg, jnp.asarray(audio), jnp.asarray(lens),
                          train=train, rng=key, interpret=True,
                          cmvn_stats=None if stats is None
                          else tuple(map(jnp.asarray, stats)))
    draws = _jax_draws(key, audio.shape[0], ref.shape[1], jcfg) if train else None
    got, got_len = port_fn(FrontendConfig(cmvn=cmvn, **cfg_kw),
                           torch.from_numpy(audio), torch.from_numpy(lens),
                           train=train, spec_draws=draws,
                           cmvn_stats=None if stats is None
                           else tuple(map(torch.from_numpy, stats)))
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    return got.numpy(), got_len.numpy()


@pytest.mark.parametrize("cmvn", ["utterance", "none", "global"])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_matches_jax_interpret_kernel(impl, cmvn):
    audio, lens = _batch()
    feats, feat_len = _compare(impl, cmvn, audio, lens)
    # frames past each row's length are exactly 0
    assert (feats[1, feat_len[1]:] == 0).all() and feat_len[1] < feats.shape[1]


@pytest.mark.parametrize("impl", list(IMPLS))
def test_nonaligned_length_matches_jax(impl):
    # a bucket whose frame count is no multiple of the TPU kernels' chunks
    audio, lens = _batch(B=3, S=16000)
    _compare(impl, "utterance", audio, lens)


@pytest.mark.parametrize("cmvn", ["utterance", "global"])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_training_with_jax_draws_matches_jax(impl, cmvn):
    audio, lens = _batch(B=3, S=16000, seed=2)
    key = jax.random.PRNGKey(11)
    feats, feat_len = _compare(impl, cmvn, audio, lens, train=True, key=key)
    valid = np.arange(feats.shape[1])[None, :] < feat_len[:, None]
    # the masks zeroed cells inside every row's valid frames
    assert all((feats[b][valid[b]] == 0).any() for b in range(3))


@pytest.mark.parametrize("impl", list(IMPLS))
def test_frontend_apply_int16_and_deltas_match_jax(impl):
    audio, lens = _batch(S=16000, seed=1)
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    ref, ref_len = jf.frontend_apply(
        JaxFrontendConfig(impl=impl, deltas=2), jnp.asarray(pcm),
        jnp.asarray(lens))
    got, got_len = tf.frontend_apply(
        FrontendConfig(impl=impl, deltas=2), torch.from_numpy(pcm),
        torch.from_numpy(lens))
    assert got.shape == ref.shape == (2, 98, 240)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_impls_agree_with_jnp_given_the_same_draws(impl):
    """With the same draws, the fused impls and ``impl: jnp`` give the
    same training features (the port's rule: randomness is an input)."""
    audio, lens = _batch(B=3, S=24000, seed=4)
    cfg = FrontendConfig(impl=impl)
    frames = tf.num_frames(audio.shape[1], cfg.win_length, cfg.hop_length)
    draws = tf.draw_spec_augment(cfg, 3, frames,
                                 torch.Generator().manual_seed(5))
    args = (torch.from_numpy(audio), torch.from_numpy(lens))
    got, _ = tf.frontend_apply(cfg, *args, train=True, spec_draws=draws)
    ref, _ = tf.frontend_apply(FrontendConfig(impl="jnp"), *args, train=True,
                               spec_draws=draws)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("impl", list(IMPLS))
def test_cpu_tensors_take_the_plain_version(impl):
    port_fn, _ = IMPLS[impl]
    plain = getattr(fused, port_fn.__name__ + "_plain")
    kernel = getattr(fused, port_fn.__name__ + "_kernel")
    audio, lens = _batch(S=8000)
    calls, launches = plain.calls, kernel.launches
    port_fn(FrontendConfig(), torch.from_numpy(audio), torch.from_numpy(lens))
    assert plain.calls == calls + 1 and kernel.launches == launches
    # the kernel's wrapper refuses a CPU tensor rather than falling back
    with pytest.raises(ValueError, match="CUDA"):
        kernel(FrontendConfig(), torch.from_numpy(audio),
               torch.from_numpy(lens))


@pytest.mark.parametrize("impl", list(IMPLS))
def test_raises_where_jax_asserts(impl):
    port_fn, _ = IMPLS[impl]
    audio, lens = _batch(S=8000)
    with pytest.raises(ValueError, match="win <= 3\\*hop"):
        port_fn(FrontendConfig(win_length=400, hop_length=100),
                torch.from_numpy(audio), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="shorter than one window"):
        port_fn(FrontendConfig(), torch.from_numpy(audio[:, :399]),
                torch.from_numpy(np.minimum(lens, 399)))
    with pytest.raises(ValueError, match="spec_draws"):
        port_fn(FrontendConfig(), torch.from_numpy(audio),
                torch.from_numpy(lens), train=True)


def test_kernel_basis_layout():
    """The kernel's basis holds frequency k's windowed (cos, sin) at
    columns 2k, 2k+1 (the TPU wrapper's (cos | sin) basis, interleaved),
    its rows padded to a multiple of 4; the mel matrix is the plain one."""
    basis, mel = fused._constants((400, 512, 80, 16000, 0.0, 8000.0),
                                  torch.device("cpu"))
    ref_basis, ref_mel = jp._constants((400, 512, 80, 16000, 0.0, 8000.0))
    assert basis.shape == (400, 516) and mel.shape == (257, 80)
    np.testing.assert_array_equal(basis[:, 0:514:2].numpy(), ref_basis[:, :257])
    np.testing.assert_array_equal(basis[:, 1:514:2].numpy(), ref_basis[:, 257:])
    assert not basis[:, 514:].any()
    np.testing.assert_array_equal(mel.numpy(), ref_mel)
