"""PyTorch port, K5/K6's FFT design (``csrc/frontend.cu::fft_kernel``) on
the CPU: a torch emulation of the kernel's decomposition, its tables,
its cluster split, its CMVN reduction and its plan.

The emulation follows the kernel step for step: the windowed frame's
even and odd samples packed as n_fft/2 complex points, Stockham passes
of radix E = n_fft/64 (then one smaller pass) whose butterflies take
their inputs at j + r N2/R, multiply input r by W_{Ns R}^{(j mod Ns) r}
from the f32 twiddle table, take an in-register radix-2 DFT (bit
reversal, then its stages) and write output r at (j - j mod Ns) R +
j mod Ns + r Ns; the real split; each mel's band summed in bin order;
the log; utterance CMVN as each rank's sums in frame order, added in
rank order. It is held to f64 ``numpy.fft.rfft`` (power bins within
1e-5 of each frame's largest), and, through log-mel, CMVN and
SpecAugment, to ``compute_features_pallas_plain`` and to the JAX
package's ``compute_features_pallas`` in interpret mode at the
frontend's tolerance, rtol 1e-3 / atol 2e-3 (tests/test_pallas_frontend.py:
log-mel through two implementations of f32 arithmetic).

The plan mirror (``fused.fft_plan``) and the cluster split are held to
copies of the C rules, which must appear verbatim in the source.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import FrontendConfig as JaxFrontendConfig
from gluon_e2e_asr_tpu.frontend import pallas_frontend as jp
from gluon_e2e_asr_tpu_torch.config import FrontendConfig, load_config
from gluon_e2e_asr_tpu_torch.frontend import features as tf
from gluon_e2e_asr_tpu_torch.frontend import fused
from gluon_e2e_asr_tpu_torch.tools.fe_probe import hard_audio

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=2e-3)
CU = os.path.join(os.path.dirname(fused.__file__), "..", "csrc", "frontend.cu")
REPO = os.path.join(os.path.dirname(__file__), "..")


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def bitrev(i, n):
    r, b = 0, 1
    while b < n:
        r, i, b = (r << 1) | (i & 1), i >> 1, b << 1
    return r


def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _dft(vr, vi, R, twr, twi, step):
    """The kernel's ``dft<R>``: [..., R] points in natural order in and
    out, radix-2 decimation in time, W_R^q = tw[q * step]."""
    perm = [bitrev(i, R) for i in range(R)]
    vr, vi = list(vr[..., perm].unbind(-1)), list(vi[..., perm].unbind(-1))
    h = 1
    while h < R:
        for q in range(h):
            t = q * (R // (2 * h)) * step
            for s in range(0, R, 2 * h):
                xr, xi = vr[s + q], vi[s + q]
                yr, yi = vr[s + q + h], vi[s + q + h]
                if q:
                    yr, yi = _cmul(yr, yi, twr[t], twi[t])
                vr[s + q], vi[s + q] = xr + yr, xi + yi
                vr[s + q + h], vi[s + q + h] = xr - yr, xi - yi
        h *= 2
    return torch.stack(vr, -1), torch.stack(vi, -1)


def _pass(sr, si, Ns, R, n_fft, twr, twi):
    """The kernel's ``pass<R, E>`` over every butterfly j = lane + 32b of
    the slice [..., n_fft/2]."""
    N2 = n_fft // 2
    j = torch.arange(N2 // R)
    k = j & (Ns - 1)
    r = torch.arange(R)
    vr = sr[..., j[:, None] + r[None, :] * (N2 // R)]
    vi = si[..., j[:, None] + r[None, :] * (N2 // R)]
    t = r[None, :] * k[:, None] * (n_fft // (Ns * R))
    mr, mi = _cmul(vr, vi, twr[t], twi[t])
    vr, vi = torch.where(r > 0, mr, vr), torch.where(r > 0, mi, vi)
    vr, vi = _dft(vr, vi, R, twr, twi, n_fft // R)
    d = (((j - k) * R + k)[:, None] + r[None, :] * Ns).reshape(-1)
    out_r, out_i = torch.empty_like(sr), torch.empty_like(si)
    out_r[..., d] = vr.reshape(*vr.shape[:-2], -1)
    out_i[..., d] = vi.reshape(*vi.shape[:-2], -1)
    return out_r, out_i


def radices(n_fft):
    """The kernel's passes (the first, then ``passes``): radix E = n_fft/64
    while a whole pass fits, then the radix left; each with its stride
    Ns."""
    N2, E = n_fft // 2, n_fft // 64
    out, Ns = [(E, 1)], E
    while Ns * E <= N2:
        out.append((E, Ns))
        Ns *= E
    if Ns < N2:
        out.append((N2 // Ns, Ns))
    return out


def emulate_power(frames, n_fft, consts):
    """Power bins [..., n_fft/2 + 1] of frames [..., n_fft] (samples past
    the frame's window are multiplied by the window's zeros)."""
    consts = torch.as_tensor(consts)
    twr, twi = consts[0:2 * n_fft:2], consts[1:2 * n_fft:2]
    x = frames * consts[2 * n_fft:3 * n_fft]
    sr, si = x[..., 0::2], x[..., 1::2]
    for R, Ns in radices(n_fft):
        sr, si = _pass(sr, si, Ns, R, n_fft, twr, twi)
    N2 = n_fft // 2
    k = torch.arange(N2 + 1)
    zr, zi = sr[..., k % N2], si[..., k % N2]
    cr, ci = sr[..., (N2 - k) % N2], si[..., (N2 - k) % N2]
    tr, ti = _cmul(zr - cr, zi + ci, twr[k], twi[k])
    re, im = 0.5 * (zr + cr + ti), 0.5 * (zi - ci - tr)
    return re * re + im * im


def emulate_mel(power, bands, weights, log_floor):
    """Each mel's run of bins in bin order (zeros past the last bin), then
    the log: [..., M]."""
    power = torch.nn.functional.pad(power, (0, 3))
    out = []
    for first, bins, off in bands.tolist():
        acc = torch.zeros(power.shape[:-1])
        for t in range(bins):
            acc = acc + power[..., first + t] * float(weights[off + t])
        out.append(acc)
    return torch.log(torch.clamp(torch.stack(out, -1), min=log_floor))


def split(live, F, r):
    """csrc/frontend.cu's split, line for line."""
    n = (live + CLUSTER - 1) // CLUSTER
    z = (F - live + CLUSTER - 1) // CLUSTER
    lo = r * n if r * n < live else live
    hi = lo + n if lo + n < live else live
    zlo = live + (r * z if r * z < F - live else F - live)
    zhi = zlo + z if zlo + z < F else F
    return lo, hi, zlo, zhi


def cluster_cmvn(x, live):
    """Utterance CMVN of one row's raw log-mel x [F, M] as the kernel
    reduces it: in each rank, G = threads // M groups, group g summing
    the rank's frames g, g + G, ... in order, the G sums added in order
    (the rank's sum, which it stores into a slot of every rank); the
    slots added in rank order; the mean, then the squared deviations."""
    F, M = x.shape
    ranks = [split(live, F, r)[:2] for r in range(CLUSTER)]
    G = 32 * _constexpr("kFftWarps") // M
    denom = float(max(live, 1))

    def reduce(v):
        total = torch.zeros(M)
        for lo, hi in ranks:
            part = torch.zeros(M)
            for g in range(G):
                t = torch.zeros(M)
                for f in range(lo + g, hi, G):
                    t = t + v[f]
                part = part + t
            total = total + part
        return total

    mean = reduce(x) / denom
    sd = torch.sqrt(reduce((x - mean) ** 2) / denom + 1e-10)
    return (x - mean) / sd


def emulate_features(cfg, audio, audio_len, train=False, draws=None,
                     stats=None):
    """The kernel's features for [B, S] audio: (feats [B, F, M],
    feat_len)."""
    B, S = audio.shape
    F = tf.num_frames(S, cfg.win_length, cfg.hop_length)
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    consts, bands, weights = fused.fft_tables(
        (cfg.win_length, cfg.n_fft, cfg.n_mels, cfg.sample_rate,
         float(cfg.fmin), float(fmax)))
    padded = torch.nn.functional.pad(audio, (0, cfg.n_fft))
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :F]
    raw = emulate_mel(emulate_power(frames, cfg.n_fft, consts), bands,
                      weights, cfg.log_floor)
    feat_len = tf.num_frames(torch.as_tensor(audio_len), cfg.win_length,
                             cfg.hop_length).to(torch.int32)
    if cfg.cmvn == "utterance":
        raw = torch.stack([cluster_cmvn(raw[b], min(int(feat_len[b]), F))
                           for b in range(B)])
    else:
        raw = tf.apply_cmvn(raw, feat_len, cfg.cmvn, stats)
    if train:
        raw = tf.spec_augment(raw, feat_len, draws, cfg.specaug_time_width)
    valid = (torch.arange(F)[None, :] < feat_len[:, None])[..., None]
    return torch.where(valid, raw, torch.zeros_like(raw)), feat_len


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _noise(B, S, seed):
    """bench.py's audio: seeded noise, rows from half to all of S."""
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    lens = np.full((B,), S, np.int32)
    lens[1:] = rng.randint(S // 2, S + 1, size=B - 1)
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


# ---------------------------------------------------------------------------
# The FFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("kind", ["noise", "tones"])
def test_fft_matches_f64_rfft(n_fft, kind):
    rng = np.random.RandomState(n_fft)
    win = n_fft * 25 // 32
    frames = np.zeros((6, n_fft), np.float32)
    if kind == "noise":
        frames[:, :win] = rng.randn(6, win) * 0.1
    else:
        t = np.arange(win) / 16000.0
        for i in range(6):
            frames[i, :win] = np.sin(2 * np.pi * (100 + 700 * i) * t) * 10.0 ** -i
    consts, _, _ = fused.fft_tables((win, n_fft, 40, 16000, 0.0, 8000.0))
    got = emulate_power(torch.from_numpy(frames), n_fft, consts).numpy()
    window = consts[2 * n_fft:].astype(np.float64)
    ref = np.abs(np.fft.rfft(frames.astype(np.float64) * window, axis=-1)) ** 2
    assert got.shape == (6, n_fft // 2 + 1)
    worst = (np.abs(got - ref) / ref.max(-1, keepdims=True)).max()
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
def test_passes_cover_the_transform(n_fft):
    """E = n_fft/64 points a lane: the radices multiply to n_fft/2, each
    pass has E/R butterflies a lane, and the strides run 1, E, E^2, ..."""
    N2, E = n_fft // 2, n_fft // 64
    passes = radices(n_fft)
    assert int(np.prod([R for R, _ in passes])) == N2
    Ns = 1
    for R, stride in passes:
        assert stride == Ns and E % R == 0
        Ns *= R
    assert [R for R, _ in radices(512)] == [8, 8, 4]


def test_fft_tables():
    consts, bands, weights = fused.fft_tables((400, 512, 80, 16000, 0.0, 8000.0))
    tw = consts[:1024].reshape(512, 2).astype(np.float64)
    ang = 2 * np.pi * np.arange(512) / 512
    np.testing.assert_allclose(tw[:, 0], np.cos(ang), atol=6e-8)
    np.testing.assert_allclose(tw[:, 1], -np.sin(ang), atol=6e-8)
    # the quarter turns are exact
    for k, w in ((0, (1, 0)), (128, (0, -1)), (256, (-1, 0)), (384, (0, 1))):
        assert tuple(tw[k]) == w
    np.testing.assert_array_equal(consts[1024:1424], tf.hann_window(400))
    assert not consts[1424:].any() and consts.dtype == np.float32
    assert bands.dtype == np.int32 and weights.dtype == np.float32


# ---------------------------------------------------------------------------
# The mel bands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [
    (400, 512, 80, 16000, 0.0, 8000.0),     # every config of the repo
    (400, 512, 40, 16000, 20.0, 7600.0),
    (200, 256, 64, 8000, 0.0, 4000.0),
    (1024, 1024, 128, 16000, 0.0, 8000.0),
    (100, 128, 80, 16000, 0.0, 8000.0),     # mels narrower than a bin
])
def test_bands_equal_the_filterbank_nonzeros(key):
    win, n_fft, M, sr, fmin, fmax = key
    fb = tf.mel_filterbank(M, n_fft, sr, fmin, fmax)
    n_freq = n_fft // 2 + 1
    _, bands, weights = fused.fft_tables(key)
    assert bands.shape == (M, 3) and not (bands % 4).any()
    dense = np.zeros((n_freq + 3, M), np.float64)
    for m, (first, bins, off) in enumerate(bands.tolist()):
        nz = np.flatnonzero(fb[:, m])
        if not len(nz):
            assert bins == 0
            continue
        run = weights[off:off + bins]
        # the run holds exactly the mel's nonzeros, at their bins: it
        # starts at most 3 bins before the first and ends at most 3 past
        # the last, within n_fft/2 + 4 bins
        assert first <= nz[0] < first + 4 and nz[-1] < first + bins <= nz[-1] + 4
        assert first + bins <= n_freq + 3
        np.testing.assert_array_equal(np.flatnonzero(run) + first, nz)
        np.testing.assert_array_equal(run[nz - first], fb[nz, m])
        dense[first:first + bins, m] = run
    np.testing.assert_array_equal(dense[:n_freq], fb.astype(np.float64))
    assert not dense[n_freq:].any()
    # the runs follow one another
    assert list(bands[1:, 2]) == list(np.cumsum(bands[:, 1])[:-1])
    assert len(weights) == max(4, int(bands[:, 1].sum()))
    if M == 80 and n_fft == 512:
        assert np.count_nonzero(weights) == 503 and bands[:, 1].max() == 20


def test_a_mel_without_weights_gives_the_floor():
    """Where a mel has no nonzero weight, its band is empty and its value
    is log(log_floor), as the dense product gives it."""
    key = (128, 128, 128, 16000, 0.0, 8000.0)
    _, bands, weights = fused.fft_tables(key)
    empty = np.flatnonzero(bands[:, 1] == 0)
    assert len(empty) == 38
    power = torch.rand(3, 65)
    out = emulate_mel(power, bands, weights, 1e-10)
    np.testing.assert_array_equal(out[:, empty].numpy(), np.log(np.float32(1e-10)))
    ref = torch.log(torch.clamp(power.double() @ torch.from_numpy(
        tf.mel_filterbank(128, 128, 16000, 0.0, 8000.0)).double(), min=1e-10))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Features against the plain version and the JAX kernel
# ---------------------------------------------------------------------------

def _compare_plain(cfg, audio, lens, train=False, seed=1):
    F = tf.num_frames(audio.shape[1], cfg.win_length, cfg.hop_length)
    draws = tf.draw_spec_augment(cfg, audio.shape[0], F,
                                 torch.Generator().manual_seed(seed)) \
        if train else None
    stats = (torch.full((cfg.n_mels,), -5.0), torch.full((cfg.n_mels,), 3.0)) \
        if cfg.cmvn == "global" else None
    a, n = torch.from_numpy(audio), torch.from_numpy(lens)
    got, got_len = emulate_features(cfg, a, n, train, draws, stats)
    ref, ref_len = fused.compute_features_pallas_plain(
        cfg, a, n, train=train, spec_draws=draws, cmvn_stats=stats)
    assert torch.equal(got_len, ref_len)
    np.testing.assert_array_equal(got.numpy() == 0, ref.numpy() == 0)
    torch.testing.assert_close(got, ref, **TOL)
    return got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cmvn", ["utterance", "global", "none"])
@pytest.mark.parametrize("audio", ["noise", "hard"])
def test_features_match_the_plain_version(cmvn, train, audio):
    make = _noise if audio == "noise" else hard_audio
    a, lens = make(3, 12000, seed=5)
    _compare_plain(FrontendConfig(cmvn=cmvn), a, lens, train)


@pytest.mark.parametrize("shape", [(1, 400), (1, 560), (2, 16000)])
def test_short_rows_and_one_row_match_the_plain_version(shape):
    """B=1, one frame, and a row shorter than one window (no frames)."""
    B, S = shape
    a, lens = _noise(B, S, seed=2)
    if B > 1:
        lens[1] = 399
    _compare_plain(FrontendConfig(), a, lens, train=True)


@pytest.mark.parametrize("n_fft,win,hop,M", [(256, 200, 80, 40),
                                             (1024, 800, 320, 64)])
def test_other_sizes_match_the_plain_version(n_fft, win, hop, M):
    # (filterbanks with no empty band: an empty band is the floor in every
    # frame, whose utterance CMVN divides rounding noise by 1e-5 in any
    # implementation)
    a, lens = hard_audio(2, 9000, seed=3)
    _compare_plain(FrontendConfig(n_fft=n_fft, win_length=win,
                                  hop_length=hop, n_mels=M), a, lens)


@pytest.mark.parametrize("cmvn,train", [("utterance", False),
                                        ("utterance", True),
                                        ("global", False), ("none", True)])
def test_features_match_the_jax_interpret_kernel(cmvn, train):
    audio, lens = hard_audio(3, 16000, seed=7)
    key = jax.random.PRNGKey(13) if train else None
    stats = (np.full((80,), -5.0, np.float32), np.full((80,), 3.0, np.float32))
    jcfg = JaxFrontendConfig(cmvn=cmvn)
    ref, ref_len = jp.compute_features_pallas(
        jcfg, jnp.asarray(audio), jnp.asarray(lens), train=train, rng=key,
        interpret=True,
        cmvn_stats=tuple(map(jnp.asarray, stats)) if cmvn == "global" else None)
    ref = np.asarray(ref)
    draws = _jax_draws(key, 3, ref.shape[1], jcfg) if train else None
    got, got_len = emulate_features(
        FrontendConfig(cmvn=cmvn), torch.from_numpy(audio),
        torch.from_numpy(lens), train, draws,
        tuple(map(torch.from_numpy, stats)) if cmvn == "global" else None)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# The cluster split and the CMVN reduction
# ---------------------------------------------------------------------------

C_SPLIT = """__host__ __device__ inline void split(int live, int F, int r, int* lo,
                                      int* hi, int* zlo, int* zhi) {
  const int n = (live + kCluster - 1) / kCluster;
  const int z = (F - live + kCluster - 1) / kCluster;
  *lo = r * n < live ? r * n : live;
  *hi = *lo + n < live ? *lo + n : live;
  *zlo = live + (r * z < F - live ? r * z : F - live);
  *zhi = *zlo + z < F ? *zlo + z : F;
}"""


def _source():
    with open(CU) as f:
        return f.read()


def _constexpr(name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                         _source())[1])


CLUSTER = _constexpr("kCluster")


@pytest.mark.parametrize("F", [1, 2, 7, 8, 9, 50, 398, 1278, 1848])
def test_split_puts_every_frame_in_one_rank(F):
    assert C_SPLIT in _source()
    P = fused.fft_plan(F, 400, 160, 512, 80)[1]
    rng = np.random.RandomState(F)
    for live in sorted({0, 1, F // 2, F - 1, F, int(rng.randint(0, F + 1))}):
        live = max(0, live)
        owner = np.full(F, -1)
        for r in range(CLUSTER):
            lo, hi, zlo, zhi = split(live, F, r)
            assert 0 <= lo <= hi <= live <= zlo <= zhi <= F
            assert hi - lo <= P  # the log-mel fits the plan's P frames
            for f in list(range(lo, hi)) + list(range(zlo, zhi)):
                assert owner[f] == -1, (live, f)
                owner[f] = r
        assert (owner >= 0).all()
        # the valid frames in rank order, contiguous
        assert list(owner[:live]) == sorted(owner[:live])


@pytest.mark.parametrize("lens", [[300, 0, 1, 150], [1], [37, 299, 300]])
def test_two_pass_reduction_matches_apply_cmvn(lens):
    rng = np.random.RandomState(len(lens))
    x = torch.from_numpy((rng.randn(len(lens), 300, 80) * 2 - 6)
                         .astype(np.float32))
    n = torch.tensor(lens, dtype=torch.int32)
    ref = tf.apply_cmvn(x, n, "utterance")
    for b, live in enumerate(lens):
        got = cluster_cmvn(x[b], live)
        np.testing.assert_allclose(got[:live].numpy(), ref[b, :live].numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The plan and the route
# ---------------------------------------------------------------------------

# csrc/frontend.cu's shared-memory layout and plan, as the C source has it ...
C_RULE = """struct FftSmem {
  size_t tw, win, slices, stats, logmel, audio, total;
  __host__ __device__ FftSmem(int n_fft, int hop, int M, int P, int Q) {
    tw = 0;
    win = tw + 2 * (size_t)n_fft;
    slices = win + n_fft;
    stats = slices + kFftWarps * slice_floats(n_fft);
    logmel = stats + 2 * kCluster * kMaxMels + kFftThreads;
    audio = logmel + round4((size_t)P * M);
    total = audio + round4((size_t)(Q - 1) * hop + n_fft);
  }
};

// How a launch covers [B, F] frames: the route, P frames a CTA at most
// (ceil(F / kCluster)), Q frames a staged chunk, and the FFT kernel's
// shared memory in bytes.
struct FftPlan {
  int route, P, Q;
  size_t smem;
};

FftPlan fe_fft_plan(int F, int win, int hop, int n_fft, int M) {
  FftPlan p;
  p.P = (F + kCluster - 1) / kCluster;
  p.Q = p.P < kChunk ? p.P : kChunk;
  p.smem = sizeof(float) * FftSmem(n_fft, hop, M, p.P, p.Q).total;
  const bool shape = n_fft >= kMinFft && n_fft <= kMaxFft &&
                     (n_fft & (n_fft - 1)) == 0 && win <= n_fft &&
                     M <= kMaxMels;
  p.route = shape && p.smem <= kMaxSmem ? kRouteFft : kRouteSpectral;
  return p;
}"""
C_SLICE = """__host__ __device__ constexpr size_t slice_floats(int n_fft) {
  return 9 * (size_t)n_fft / 8;
}"""


def c_rule(F, win, hop, n_fft, M):
    """... and in Python, line for line."""
    r4 = lambda n: (n + 3) & ~3  # noqa: E731
    P = (F + CLUSTER - 1) // CLUSTER
    Q = P if P < _constexpr("kChunk") else _constexpr("kChunk")
    threads = 32 * _constexpr("kFftWarps")  # kFftThreads
    total = (2 * n_fft + n_fft + _constexpr("kFftWarps") * (9 * n_fft // 8)
             + 2 * CLUSTER * _constexpr("kMaxMels") + threads + r4(P * M)
             + r4((Q - 1) * hop + n_fft))
    smem = 4 * total
    shape = (_constexpr("kMinFft") <= n_fft <= _constexpr("kMaxFft")
             and n_fft & (n_fft - 1) == 0 and win <= n_fft
             and M <= _constexpr("kMaxMels"))
    fits = smem <= _constexpr("kMaxSmem")
    return ("fft" if shape and fits else "spectral"), P, Q, smem


def test_plan_mirror_matches_the_c_rule():
    src = _source()
    assert C_RULE in src and C_SLICE in src
    assert "#define FE_FFT 1" in src
    assert "constexpr int kFftThreads = 32 * kFftWarps;" in src
    assert (fused.CLUSTER, fused.WARPS, fused.CHUNK, fused.MIN_FFT,
            fused.MAX_FFT, fused.MAX_SMEM, fused.MAX_MELS) == tuple(
        _constexpr(n) for n in ("kCluster", "kFftWarps", "kChunk", "kMinFft",
                                "kMaxFft", "kMaxSmem", "kMaxMels"))
    assert fused.ROUTES == {"spectral": _constexpr("kRouteSpectral"),
                            "fft": _constexpr("kRouteFft")}
    rng = np.random.RandomState(0)
    shapes = [(int(rng.randint(1, 4000)), int(w), 4 * int(rng.randint(1, 200)),
               int(n), int(rng.randint(1, 129)))
              for n, w in zip(rng.choice([100, 128, 256, 400, 512, 1024, 2048,
                                          4096], 2000),
                              rng.randint(50, 2100, 2000))]
    shapes += [(398, 400, 160, 512, 80), (1848, 400, 160, 512, 80),
               (1, 2048, 1024, 2048, 128), (5000, 400, 160, 512, 80)]
    for shape in shapes:
        assert fused.fft_plan(*shape) == c_rule(*shape), shape


def test_route_by_shape():
    # milestone 2's 4.0 s bucket: 50 frames a CTA, one chunk
    assert fused.fft_plan(398, 400, 160, 512, 80)[:3] == ("fft", 50, 50)
    # the longest bucket of any config (18.5 s): 231 frames a CTA
    assert fused.fft_plan(1848, 400, 160, 512, 80)[:3] == ("fft", 231, 64)
    # n_fft 400 is no power of two; win > n_fft; too many frames to hold
    assert fused.route(FrontendConfig(n_fft=400), 398) == "spectral"
    assert fused.route(FrontendConfig(n_fft=256, win_length=400), 98) == "spectral"
    assert fused.route(FrontendConfig(), 6000) == "spectral"
    assert fused.route(FrontendConfig(n_fft=4096, win_length=400), 10) == "spectral"


def test_every_config_takes_the_fft_route():
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(paths) >= 10
    for path in paths:
        config = load_config(path)
        fc = config.frontend
        for sec in config.data.bucket_bounds_sec:
            F = tf.num_frames(int(round(sec * fc.sample_rate)), fc.win_length,
                              fc.hop_length)
            assert fused.route(fc, F) == "fft", (path, sec)
