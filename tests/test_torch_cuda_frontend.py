"""PyTorch port on the card: the fused frontend kernels K5 and K6
(csrc/frontend.cu through frontend/fused.py) against their plain versions
at small, ragged shapes, in every CMVN mode, in eval and in training
(the same SpecAugment draws on both sides), with deltas through
``frontend_apply``; and a shape the kernels refuse raises on a CUDA
tensor instead of falling back. The FFT route (``fft_kernel``) at the
main path's four shapes (``tools/fe_probe.py::SHAPES``), on hard audio
(tones, digital silence, -60 dB), at B=1 and with rows shorter than a
window, one launch a call (``.fft_launches`` and torch.profiler); n_fft
= 400 through ``spectral_kernel``; the plan mirror against the
library's, and a route that is not the plan's refused.

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


def _check(dev, impl, cfg, audio, lens, train=False, route="fft", seed=1):
    """One call of ``impl``'s kernel on the card against its plain
    version: launched once, through ``route``, within TOL, the masked
    cells exactly 0."""
    from gluon_e2e_asr_tpu_torch.frontend import features as F
    from gluon_e2e_asr_tpu_torch.frontend import fused

    B, S = audio.shape
    frames = F.num_frames(S, cfg.win_length, cfg.hop_length)
    assert fused.route(cfg, frames) == route
    stats = _stats(dev) if cfg.cmvn == "global" else None
    draws = F.draw_spec_augment(cfg, B, frames,
                                torch.Generator().manual_seed(seed), dev) \
        if train else None
    name = "compute_features_" + impl
    kernel = getattr(fused, name + "_kernel")
    launches, fft = kernel.launches, kernel.fft_launches
    kw = dict(train=train, spec_draws=draws, cmvn_stats=stats)
    got, got_len = kernel(cfg, audio, lens, **kw)
    ref, ref_len = getattr(fused, name + "_plain")(cfg, audio, lens, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert kernel.fft_launches == fft + (route == "fft")
    assert torch.equal(got_len, ref_len)
    assert torch.isfinite(got).all()
    keep = (torch.arange(frames, device=dev)[None, :] < ref_len[:, None])
    keep = keep[..., None].expand(*got.shape).float()
    if train:
        keep = F.spec_augment(keep, ref_len, draws, cfg.specaug_time_width)
    assert not got[keep == 0].any() and not ref[keep == 0].any()
    torch.testing.assert_close(got, ref, **TOL)


def _shapes():
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import SHAPES

    return SHAPES


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
@pytest.mark.parametrize("shape", range(4))
def test_fft_kernel_at_the_main_path_shapes(dev, shape, cmvn, train):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import audio_batch

    _, B, sec = _shapes()[shape]
    audio, lens = audio_batch(B, sec, dev)
    for impl in ("pallas", "pallas_regrid"):
        _check(dev, impl, FrontendConfig(cmvn=cmvn), audio, lens, train)


@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
@pytest.mark.parametrize("B,S", [(16, 64000), (1, 64000), (1, 400),
                                 (4, 2400)])
def test_fft_kernel_on_hard_audio_and_short_rows(dev, B, S, cmvn):
    """Tones with digital silence and a -60 dB stretch; B=1; a single
    frame; rows of no frame and of one (lengths 0, 399, 400)."""
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import hard_audio

    audio, lens = hard_audio(B, S, seed=B + S)
    if B == 4:
        lens[1:] = (0, 399, 400)
    audio, lens = torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev)
    for impl in ("pallas", "pallas_regrid"):
        for train in (False, True):
            _check(dev, impl, FrontendConfig(cmvn=cmvn), audio, lens, train)


@pytest.mark.parametrize("cmvn", ["utterance", "global"])
def test_n_fft_400_takes_the_spectral_kernel(dev, cmvn):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import fused
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import one_call

    cfg = FrontendConfig(n_fft=400, cmvn=cmvn)
    audio, lens = _audio(5, 32000, dev)
    for impl in ("pallas", "pallas_regrid"):
        for train in (False, True):
            _check(dev, impl, cfg, audio, lens, train, route="spectral")
    stats = _stats(dev) if cmvn == "global" else None
    ops = one_call(lambda: fused.compute_features_pallas_regrid_kernel(
        cfg, audio, lens, cmvn_stats=stats))
    names = [n for n, _ in ops]
    assert any("spectral_kernel" in n for n in names)
    assert any("cmvn_kernel" in n for n in names) == (cmvn == "utterance")
    assert not any("fft_kernel" in n for n in names)


@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
def test_fft_route_is_one_launch_a_call(dev, impl):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import features as F
    from gluon_e2e_asr_tpu_torch.frontend import fused
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import audio_batch, one_call

    cfg = FrontendConfig(cmvn="utterance")
    audio, lens = audio_batch(16, 4.0, dev)
    draws = F.draw_spec_augment(cfg, 16, 398, torch.Generator().manual_seed(0),
                                dev)
    kernel = getattr(fused, f"compute_features_{impl}_kernel")
    fft = kernel.fft_launches
    ops = one_call(lambda: kernel(cfg, audio, lens, train=True,
                                  spec_draws=draws))
    assert len(ops) == 1 and "fft_kernel" in ops[0][0] and ops[0][1] <= 5, ops
    assert kernel.fft_launches == fft + 6  # a warm-up and five calls


def test_plan_mirror_matches_the_library(dev):
    import ctypes

    from gluon_e2e_asr_tpu_torch.frontend import fused

    lib = fused._lib()
    out = (ctypes.c_int * 4)()
    rng = np.random.RandomState(0)
    shapes = [(398, 400, 160, 512, 80), (1848, 400, 160, 512, 80),
              (1278, 400, 160, 512, 80), (398, 400, 160, 400, 80),
              (14, 2048, 1024, 2048, 128), (6000, 400, 160, 512, 80)]
    shapes += [(int(rng.randint(1, 3000)), 400, 160,
                int(rng.choice([128, 256, 400, 512, 1024, 2048])),
                int(rng.randint(1, 129))) for _ in range(200)]
    for shape in shapes:
        assert lib.frontend_plan(*shape, out) == 0
        route, P, Q, smem = fused.fft_plan(*shape)
        assert tuple(out) == (fused.ROUTES[route], P, Q, smem), shape


def test_a_route_that_is_not_the_plans_raises(dev, monkeypatch):
    from gluon_e2e_asr_tpu_torch.config import FrontendConfig
    from gluon_e2e_asr_tpu_torch.frontend import fused

    audio, lens = _audio(2, 8000, dev)
    monkeypatch.setattr(fused, "route", lambda cfg, F: "spectral")
    launches = fused.compute_features_pallas_kernel.launches
    with pytest.raises(RuntimeError, match="route differs"):
        fused.compute_features_pallas_kernel(FrontendConfig(), audio, lens)
    assert fused.compute_features_pallas_kernel.launches == launches
