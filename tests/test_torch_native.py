"""PyTorch port: its own copy of the native host-path library
(``gluon_e2e_asr_tpu_torch/native/asr_native.cpp`` through
``utils/native.py``) against the JAX package's.

The FLAC decoder on every code path of ``tests/test_flac.py`` (the
subframe kinds, constant and wasted bits, the stereo modes, the 32-bit
side channel) and on every signal of ``tests/test_flac_encoder_native.py``
decodes bit for bit as JAX's; the encoder writes the same bytes as JAX's
and round-trips exactly; ``probe_flac`` reads the header alone; malformed
and mutated files raise or decode, never crash; the wav reader, the fused
batch loaders (float32 and int16), ``pack_waves`` and the edit distance
give JAX's results. The library builds into the ignored ``build/native/``
and a failed build raises with the compiler's stderr.
"""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from gluon_e2e_asr_tpu.utils import native as jn
from gluon_e2e_asr_tpu_torch.utils import native as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from flacenc import encode_flac as py_encode_flac  # noqa: E402
from flacenc import write_flac  # noqa: E402


def _sig(n=6000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    s = 3000 * np.sin(2 * np.pi * 440 * t / 16000) + 200 * rng.randn(n)
    return np.clip(s, -32768, 32767).astype(np.int64)


def _stereo(seed=0):
    s = _sig(seed=seed)
    return np.stack([s, np.roll(s, 3) + 50], axis=1)


def _side32():
    n = 256
    rng = np.random.RandomState(7)
    l = rng.randint(-2**31, 2**31, n).astype(np.int64)
    r = rng.randint(-2**31, 2**31, n).astype(np.int64)
    l[0], r[0] = 2**31 - 1, -(2**31)
    l[1], r[1] = -(2**31), 2**31 - 1
    return np.stack([l, r], axis=1)


# tests/test_flac.py's files: (name, PCM, flacenc.write_flac keywords)
FLACENC_CASES = [
    ("auto", _sig(), {}),
    ("verbatim", _sig(), {"force_subframe": "verbatim"}),
    ("fixed", _sig(), {"force_subframe": "fixed"}),
    ("fixed-part", _sig(), {"force_subframe": "fixed", "porder": 3}),
    ("lpc1", _sig(), {"force_subframe": "lpc", "lpc_order": 1,
                      "lpc_shift": 3}),
    ("lpc2", _sig(), {"force_subframe": "lpc", "lpc_order": 2,
                      "lpc_shift": 4}),
    ("lpc8", _sig(), {"force_subframe": "lpc", "lpc_order": 8,
                      "lpc_shift": 5}),
    ("escape", _sig(), {"force_subframe": "fixed", "force_escape": True}),
    ("small-block", _sig(), {"block_size": 192}),
    ("constant", np.full(1000, -77, np.int64), {}),
    ("wasted", (_sig() >> 3) << 3, {"wasted": 3}),
    *[(f"stereo-{m}", _stereo(), {"channel_mode": m})
      for m in ("indep", "left_side", "right_side", "mid_side")],
    *[(f"side32-{m}", _side32(), {"bps": 32, "channel_mode": m,
                                  "force_subframe": "verbatim"})
      for m in ("left_side", "right_side", "mid_side")],
]

# tests/test_flac_encoder_native.py's signals
ENCODER_CASES = [
    ("tone", (np.sin(np.arange(48000) * 0.07) * 18000)),
    ("noise", np.random.RandomState(7).randint(-32768, 32768, 30001)),
    ("constant", np.full(9000, -123)),
    ("silence", np.zeros(5000)),
    ("ramp", np.arange(-16000, 16000, 2)),
    ("extremes", np.tile([-32768, 32767], 3000)),
    ("tiny", np.array([1, -2, 3])),
    ("one", np.array([42])),
    ("empty", np.zeros(0)),
    ("block_edge", np.random.RandomState(1).randint(-100, 100, 4096)),
    ("block_edge_p1", np.random.RandomState(2).randint(-100, 100, 4097)),
    ("random_walk", np.cumsum(np.random.RandomState(3).randn(20000)) * 100),
]


def _pcm16(x):
    return np.clip(np.asarray(x, np.int64), -32768, 32767).astype(np.int16)


def test_the_library_builds_into_the_ignored_build_dir():
    tn.get_lib()
    assert os.path.exists(tn._LIB_PATH)
    assert os.path.dirname(tn._LIB_PATH) == os.path.join(REPO, "build",
                                                         "native")
    name = os.path.basename(tn._LIB_PATH)
    assert name.endswith(f".{tn._host_tag()}.so")
    ignored = subprocess.run(["git", "check-ignore", "-q", tn._LIB_PATH],
                             cwd=REPO)
    assert ignored.returncode == 0


def test_a_failed_build_raises_with_the_compilers_stderr(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(tn, "_SRC_PATH", str(bad))
    monkeypatch.setattr(tn, "_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tn, "_LIB_PATH", str(tmp_path / "out" / "lib.so"))
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_build_error", None)
    for _ in range(2):  # the same error again, without a second build
        with pytest.raises(RuntimeError, match="bad.cpp") as e:
            tn.get_lib()
        assert "error" in str(e.value)
    assert not os.listdir(tmp_path / "out")


@pytest.mark.parametrize("name,pcm,kw", FLACENC_CASES,
                         ids=[c[0] for c in FLACENC_CASES])
def test_decode_of_flacenc_files_matches_jax(tmp_path, name, pcm, kw):
    path = str(tmp_path / f"{name}.flac")
    write_flac(path, pcm, **kw)
    ours, ref = tn.decode_flac(path), jn.decode_flac(path)
    assert ours.dtype == ref.dtype == np.float32 and len(ours) == len(pcm)
    np.testing.assert_array_equal(ours, ref)
    assert tn.probe_flac(path) == jn.probe_flac(path) == (16000, len(pcm))


@pytest.mark.parametrize("name,pcm", ENCODER_CASES,
                         ids=[c[0] for c in ENCODER_CASES])
def test_encoder_matches_jax_and_round_trips(tmp_path, name, pcm):
    pcm = _pcm16(pcm)
    ours, ref = str(tmp_path / "t.flac"), str(tmp_path / "j.flac")
    tn.encode_flac(ours, pcm)
    jn.encode_flac(ref, pcm)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert tn.probe_flac(ours) == (16000, len(pcm))
    dec = tn.decode_flac(ours)
    np.testing.assert_array_equal(dec, jn.decode_flac(ours))
    back = np.round(dec.astype(np.float64) * 32768.0).astype(np.int64)
    np.testing.assert_array_equal(back, pcm.astype(np.int64))


def test_probe_reads_the_header_alone_and_rates_are_checked(tmp_path):
    path = str(tmp_path / "full.flac")
    write_flac(path, _sig(9876), sample_rate=16000)
    with open(path, "rb") as f:
        head = f.read(42)
    trunc = str(tmp_path / "head_only.flac")
    with open(trunc, "wb") as f:
        f.write(head)
    assert tn.probe_flac(trunc) == jn.probe_flac(trunc) == (16000, 9876)
    with pytest.raises(ValueError, match="rc=-3"):
        tn.decode_flac(path, expect_rate=8000)
    with pytest.raises(ValueError):
        tn.encode_flac(str(tmp_path / "b.flac"), np.zeros(4, np.int16),
                       sample_rate=-1)
    with pytest.raises(ValueError):
        tn.encode_flac(str(tmp_path / "no_dir" / "b.flac"),
                       np.zeros(4, np.int16))


@pytest.mark.parametrize("blob", [b"fLaC" + bytes(range(64)), b"fLaC",
                                  b"RIFF\0\0\0\0WAVE", b""],
                         ids=["garbage", "magic_only", "wav_magic", "empty"])
def test_malformed_flac_raises(tmp_path, blob):
    path = str(tmp_path / "bad.flac")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError):
        tn.decode_flac(path)
    with pytest.raises(ValueError):
        tn.decode_flac(str(tmp_path / "missing.flac"))


def test_fuzzed_files_never_crash_and_match_jax(tmp_path):
    """Seeded bit flips and truncations of a valid stream either decode,
    as JAX's decoder does, or raise in both."""
    base = py_encode_flac(_sig(3000), block_size=512)
    rng = np.random.RandomState(42)
    path = str(tmp_path / "fuzz.flac")
    mutants = []
    for _ in range(100):
        buf = bytearray(base)
        pos = int(rng.randint(4, len(buf)))  # keep the fLaC magic
        buf[pos] ^= 1 << int(rng.randint(8))
        mutants.append(bytes(buf))
    mutants += [base[:cut] for cut in range(4, len(base), 53)]
    decoded = 0
    for blob in mutants:
        with open(path, "wb") as f:
            f.write(blob)
        try:
            ours = tn.decode_flac(path, max_samples=16000)
        except ValueError:
            with pytest.raises(ValueError):
                jn.decode_flac(path, max_samples=16000)
            continue
        decoded += 1
        assert ours.dtype == np.float32 and ours.ndim == 1
        np.testing.assert_array_equal(
            ours, jn.decode_flac(path, max_samples=16000))
    assert 0 < decoded < len(mutants)


def _write_wav(path, pcm, channels=1):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype("<i2").tobytes())


def test_decode_wav_matches_jax(tmp_path):
    mono, st = str(tmp_path / "m.wav"), str(tmp_path / "s.wav")
    _write_wav(mono, _sig(5000))
    _write_wav(st, _stereo().reshape(-1), channels=2)
    for p in (mono, st):
        np.testing.assert_array_equal(tn.decode_wav(p), jn.decode_wav(p))
    with pytest.raises(ValueError):
        tn.decode_wav(mono, expect_rate=8000)


@pytest.mark.parametrize("fn", ["load_pack_audio_batch",
                                "load_pack_audio_batch_i16"])
def test_fused_batch_loaders_match_jax(tmp_path, fn):
    """Mixed wav and flac rows, a row longer than the batch's width (cut),
    and pad rows."""
    sigs = [_sig(3000, 1), _sig(5000, 2), _sig(2000, 3), _sig(7000, 4)]
    paths = []
    for i, s in enumerate(sigs):
        p = str(tmp_path / f"{i}.{'wav' if i == 1 else 'flac'}")
        if i == 1:
            _write_wav(p, s)
        else:
            tn.encode_flac(p, _pcm16(s))
        paths.append(p)
    for nthreads in (1, 3):
        a, la = getattr(tn, fn)(paths, 16000, 6000, 6, nthreads)
        b, lb = getattr(jn, fn)(paths, 16000, 6000, 6, nthreads)
        assert a.dtype == b.dtype and a.shape == (6, 6000)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert list(la) == [3000, 5000, 2000, 6000, 0, 0]
    with pytest.raises(ValueError):
        getattr(tn, fn)(paths + [str(tmp_path / "missing.flac")], 16000,
                        6000, 6)


def test_pack_waves_matches_jax():
    rng = np.random.RandomState(0)
    waves = [rng.randn(n).astype(np.float32) for n in (10, 300, 0, 129)]
    for a, b in zip(tn.pack_waves(waves, 200, 6), jn.pack_waves(waves, 200, 6)):
        np.testing.assert_array_equal(a, b)


def test_edit_distance_matches_jax():
    rng = np.random.RandomState(1)
    words = ["a", "bb", "cat", "dog", "", "fox", "é"]
    for _ in range(50):
        ref = list(rng.choice(words, rng.randint(0, 12)))
        hyp = list(rng.choice(words, rng.randint(0, 12)))
        assert tn.edit_distance_native(ref, hyp) == \
            jn.edit_distance_native(ref, hyp)
    assert tn.edit_distance_native(list("kitten"), list("sitting")) == 3
