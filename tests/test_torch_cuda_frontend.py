"""PyTorch port on the card: the fused frontend kernels K5 and K6
(csrc/frontend.cu through frontend/fused.py) against their plain versions
at small, ragged shapes, in every CMVN mode, in eval and in training
(the same SpecAugment draws on both sides), with deltas through
``frontend_apply``; and a shape the kernels refuse raises on a CUDA
tensor instead of falling back.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_frontend.py``.

Tolerance: the JAX suite's for the frontend, rtol 1e-3 / atol 2e-3 (two
implementations of true-f32 products, features in the log domain);
masked cells (past feat_len, SpecAugment's) are exactly 0 on both sides.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-3, atol=2e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _audio(B, S, dev, seed=0):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    lens = rng.randint(400, S + 1, size=B).astype(np.int32)
    lens[0] = S
    if B > 2:
        lens[-1] = 0  # a pad row
    return torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev)


def _stats(dev):
    rng = np.random.RandomState(3)
    return (torch.from_numpy(rng.randn(80).astype(np.float32) - 5.0).to(dev),
            torch.from_numpy(rng.rand(80).astype(np.float32) * 3 + 0.5).to(dev))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
@pytest.mark.parametrize("shape", [(3, 8123), (5, 32000), (2, 400)])
def test_kernel_matches_plain(dev, impl, cmvn, train, shape):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import features as F
    from gluon_e2e_asr_tpu_torch.frontend import fused

    cfg = FrontendConfig(cmvn=cmvn, impl=impl)
    audio, lens = _audio(*shape, dev)
    stats = _stats(dev) if cmvn == "global" else None
    frames = F.num_frames(shape[1], cfg.win_length, cfg.hop_length)
    draws = F.draw_spec_augment(cfg, shape[0], frames,
                                torch.Generator().manual_seed(1), dev) \
        if train else None
    name = "compute_features_" + impl
    kernel = getattr(fused, name + "_kernel")
    plain = getattr(fused, name + "_plain")
    launches = kernel.launches
    got, got_len = getattr(fused, name)(cfg, audio, lens, train=train,
                                        spec_draws=draws, cmvn_stats=stats)
    ref, ref_len = plain(cfg, audio, lens, train=train, spec_draws=draws,
                         cmvn_stats=stats)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert got.shape == ref.shape == (shape[0], frames, 80)
    assert torch.equal(got_len, ref_len)
    assert torch.isfinite(got).all()
    # the cells the frontend must zero: past feat_len, and SpecAugment's
    keep = (torch.arange(frames, device=dev)[None, :] < ref_len[:, None])
    keep = keep[..., None].expand(*got.shape).float()
    if train:
        keep = F.spec_augment(keep, ref_len, draws, cfg.specaug_time_width)
    masked = keep == 0
    assert not got[masked].any() and not ref[masked].any()
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
def test_frontend_apply_with_deltas_and_int16(dev, impl):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import features as F

    audio, lens = _audio(4, 16000, dev, seed=2)
    pcm = torch.clamp(torch.round(audio * 32768.0), -32768, 32767).to(torch.int16)
    got, got_len = F.frontend_apply(FrontendConfig(impl=impl, deltas=2), pcm, lens)
    ref, ref_len = F.frontend_apply(FrontendConfig(impl=impl, deltas=2),
                                    pcm.cpu(), lens.cpu())
    assert torch.equal(got_len.cpu(), ref_len)
    torch.testing.assert_close(got.cpu(), ref, **TOL)


def test_refused_shapes_raise_on_the_card(dev):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import fused

    audio, lens = _audio(2, 8000, dev)
    calls = fused.compute_features_pallas_plain.calls
    with pytest.raises(ValueError, match="n_mels"):
        fused.compute_features_pallas(FrontendConfig(n_mels=200), audio, lens)
    with pytest.raises(ValueError, match="contiguous"):
        fused.compute_features_pallas(FrontendConfig(), audio.t().contiguous().t(),
                                      lens)
    with pytest.raises(ValueError, match="shorter than one window"):
        fused.compute_features_pallas_regrid(FrontendConfig(), audio[:, :300]
                                             .contiguous(), lens)
    assert fused.compute_features_pallas_plain.calls == calls
