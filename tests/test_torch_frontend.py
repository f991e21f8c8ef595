"""PyTorch port: the frontend against the JAX package's ``impl: jnp``
path on the CPU, at the JAX suite's frontend tolerance (rtol 1e-3,
atol 2e-3, tests/test_pallas_frontend.py: log-mel features through two
implementations of f32 matmuls)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import FrontendConfig
from gluon_e2e_asr_tpu.frontend import features as jf
from gluon_e2e_asr_tpu_torch.frontend import features as tf

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=2e-3)


def _batch(B=2, S=32000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(S) / 16000.0
    audio = np.stack([
        (np.sin(2 * np.pi * (200 + 150 * b) * t) * 0.5).astype(np.float32)
        for b in range(B)])
    audio += 0.01 * rng.randn(B, S).astype(np.float32)
    lens = np.array([S] + [S - 3200 * b for b in range(1, B)], np.int32)
    return audio, lens


def _stats(cfg):
    return (np.full((cfg.n_mels,), -5.0, np.float32),
            np.full((cfg.n_mels,), 3.0, np.float32))


@pytest.mark.parametrize("deltas", [0, 2])
@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
def test_frontend_apply_matches_jax(cmvn, deltas):
    cfg = FrontendConfig(cmvn=cmvn, deltas=deltas)
    audio, lens = _batch()
    stats = _stats(cfg) if cmvn == "global" else None
    ref, ref_len = jf.frontend_apply(
        cfg, jnp.asarray(audio), jnp.asarray(lens),
        cmvn_stats=None if stats is None else tuple(map(jnp.asarray, stats)))
    got, got_len = tf.frontend_apply(
        cfg, torch.from_numpy(audio), torch.from_numpy(lens),
        cmvn_stats=None if stats is None else tuple(map(torch.from_numpy, stats)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_int16_audio_matches_jax():
    cfg = FrontendConfig(cmvn="utterance")
    audio, lens = _batch(S=16000, seed=1)
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    ref, ref_len = jf.frontend_apply(cfg, jnp.asarray(pcm), jnp.asarray(lens))
    got, got_len = tf.frontend_apply(cfg, torch.from_numpy(pcm),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # The dequant is an exact power-of-two scale: int16 in equals f32 in.
    f32, _ = tf.frontend_apply(
        cfg, torch.from_numpy(pcm.astype(np.float32) * 2.0 ** -15),
        torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), f32.numpy())


def test_constant_matrices_equal_jax():
    np.testing.assert_array_equal(tf.dft_basis(400, 512)[0],
                                  jf.dft_basis(400, 512)[0])
    np.testing.assert_array_equal(tf.hann_window(400), jf.hann_window(400))
    np.testing.assert_array_equal(tf.mel_filterbank(80, 512, 16000, 0.0, 8000.0),
                                  jf.mel_filterbank(80, 512, 16000, 0.0, 8000.0))
    for n in (0, 399, 400, 32000):
        assert tf.num_frames(n, 400, 160) == jf.num_frames(n, 400, 160)
    lens = np.array([0, 399, 400, 561, 32000], np.int32)
    np.testing.assert_array_equal(
        tf.num_frames(torch.from_numpy(lens), 400, 160).numpy(),
        np.asarray(jf.num_frames(jnp.asarray(lens), 400, 160)))


def test_frame_signal_matches_jax():
    audio, _ = _batch(S=4000)
    np.testing.assert_array_equal(
        tf.frame_signal(torch.from_numpy(audio), 400, 160).numpy(),
        np.asarray(jf.frame_signal(jnp.asarray(audio), 400, 160)))


@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
def test_tpu_kernel_impls_run(impl):
    """The impls of K5 and K6 (frontend/fused.py) run; on the CPU they take
    their plain versions, which give the jnp path's features."""
    audio, lens = _batch(S=4000)
    args = (torch.from_numpy(audio), torch.from_numpy(lens))
    got, got_len = tf.frontend_apply(FrontendConfig(impl=impl), *args)
    ref, ref_len = tf.frontend_apply(FrontendConfig(impl="jnp"), *args)
    assert torch.equal(got_len, ref_len)
    assert torch.equal(got, ref)


def test_unknown_impl_raises():
    audio, lens = _batch(S=4000)
    with pytest.raises(ValueError, match="not in"):
        tf.frontend_apply(FrontendConfig(impl="fft"), torch.from_numpy(audio),
                          torch.from_numpy(lens))
