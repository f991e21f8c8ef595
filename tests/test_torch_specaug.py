"""PyTorch port: SpecAugment (the training frontend) against the JAX
package on the CPU.

The mask geometry is an input of the port's ``spec_augment``. Fed the
JAX draws (``jax.random.randint`` on the four keys that
``frontend/features.py::spec_augment`` splits from its key), it must
zero exactly the cells the JAX function zeroes: the comparison is
exact. Through the whole training frontend the comparison holds at the
frontend's own tolerance (tests/test_torch_frontend.py). The port's own
draws (``draw_spec_augment``, a ``torch.Generator``) are checked for
their ranges and means.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import FrontendConfig
from gluon_e2e_asr_tpu.frontend import features as jax_features
from gluon_e2e_asr_tpu_torch.frontend import features as F

torch.set_num_threads(1)

CFG = FrontendConfig(specaug_freq_masks=2, specaug_freq_width=27,
                     specaug_time_masks=2, specaug_time_width=40)


def _jax_draws(key, B, frames, cfg=CFG):
    """The draws of the JAX spec_augment, as F.SpecAugDraws."""
    M = cfg.n_mels
    keys = jax.random.split(key, 4)
    nf, nt = cfg.specaug_freq_masks, cfg.specaug_time_masks
    fw = jax.random.randint(keys[0], (B, nf, 1), 0, cfg.specaug_freq_width + 1)
    fs = jax.random.randint(keys[1], (B, nf, 1), 0, jnp.maximum(M - fw + 1, 1))
    tw = jax.random.randint(keys[2], (B, nt, 1), 0, cfg.specaug_time_width + 1)
    ts = jax.random.randint(keys[3], (B, nt, 1), 0, frames)
    return F.SpecAugDraws(*(torch.from_numpy(np.asarray(d).astype(np.int64))
                            for d in (fw, fs, tw, ts)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_with_jax_draws_is_exact(seed):
    rng = np.random.RandomState(seed)
    B, frames = 5, 230
    feats = rng.randn(B, frames, CFG.n_mels).astype(np.float32)
    feat_len = np.array([230, 199, 60, 4, 1], np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_features.spec_augment(
        jnp.asarray(feats), jnp.asarray(feat_len), key,
        CFG.specaug_freq_masks, CFG.specaug_freq_width,
        CFG.specaug_time_masks, CFG.specaug_time_width))
    got = F.spec_augment(torch.from_numpy(feats), torch.from_numpy(feat_len),
                         _jax_draws(key, B, frames), CFG.specaug_time_width)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any(axis=(1, 2)).all()  # every row got a mask


def test_training_frontend_with_jax_draws_matches_jax():
    rng = np.random.RandomState(3)
    B, S = 3, 16000
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    audio_len = np.array([16000, 12000, 4000], np.int32)
    key = jax.random.PRNGKey(7)
    ref, ref_len = jax_features.frontend_apply(
        CFG, jnp.asarray(audio), jnp.asarray(audio_len), train=True, rng=key)
    frames = ref.shape[1]
    got, got_len = F.frontend_apply(
        CFG, torch.from_numpy(audio), torch.from_numpy(audio_len), train=True,
        spec_draws=_jax_draws(key, B, frames))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=2e-3)


def test_training_frontend_needs_draws():
    audio = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="spec_draws"):
        F.frontend_apply(CFG, audio, torch.tensor([4000]), train=True)
    off = FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0)
    feats, _ = F.frontend_apply(off, audio, torch.tensor([4000]), train=True)
    assert feats.shape[0] == 1


def test_port_draws_statistics():
    g = torch.Generator().manual_seed(0)
    B, frames = 4000, 300
    d = F.draw_spec_augment(CFG, B, frames, g)
    M = CFG.n_mels
    assert d.freq_width.shape == (B, CFG.specaug_freq_masks, 1)
    assert d.freq_width.min() == 0 and d.freq_width.max() == CFG.specaug_freq_width
    assert (d.freq_start >= 0).all()
    assert (d.freq_start <= torch.clamp(M - d.freq_width, min=0)).all()
    assert d.time_width.min() == 0 and d.time_width.max() == CFG.specaug_time_width
    assert d.time_start.min() == 0 and d.time_start.max() == frames - 1
    # Uniform draws: means within 3 standard errors of the expected ones.
    n = d.freq_width.numel()
    for x, hi in ((d.freq_width, CFG.specaug_freq_width),
                  (d.time_width, CFG.specaug_time_width),
                  (d.time_start, frames - 1)):
        sd = np.sqrt(((hi + 1) ** 2 - 1) / 12.0)
        assert abs(float(x.double().mean()) - hi / 2.0) < 3 * sd / np.sqrt(n)
    # The start is uniform below M - w + 1: its mean fraction is 1/2.
    frac = (d.freq_start.double() + 0.5) / (M - d.freq_width + 1).double()
    assert abs(float(frac.mean()) - 0.5) < 3 * np.sqrt(1 / 12.0 / n)
    again = F.draw_spec_augment(CFG, B, frames, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(d, again))


def test_masks_off_draw_nothing():
    off = FrontendConfig(specaug_freq_masks=0, specaug_time_masks=2,
                         specaug_time_width=0)
    d = F.draw_spec_augment(off, 2, 50, torch.Generator().manual_seed(0))
    assert d == F.SpecAugDraws(None, None, None, None)
