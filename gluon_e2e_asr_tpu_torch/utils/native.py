"""ctypes bindings for the native host-path library.

The port's own copy of ``gluon_e2e_asr_tpu/utils/native.py`` over its
own copy of the C++ source, ``gluon_e2e_asr_tpu_torch/native/
asr_native.cpp`` (byte for byte the JAX package's): the FLAC decoder and
encoder, the wav reader, the fused multi-threaded read+decode+pack of a
bucket batch (float32 and int16), ``pack_waves`` and the edit distance.
``tests/test_torch_data.py`` holds the two modules to the same code
apart from where the library is built and what a failed build does.

The library is built with g++ on first use, never at import, into
``build/native/`` at the root of the checkout. Its file name carries a
digest of the source and a tag of the host's CPU flags (the build uses
``-march=native``, so a binary built on another host is never loaded).
Each build goes to a temporary name and is renamed, so processes that
race on it (pytest-xdist workers) are safe. A failed build raises with
the compiler's stderr wherever a caller needs the library: there is no
Python FLAC decoder to fall back on (the JAX package's ``get_lib``
returns None instead).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_ROOT, "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "asr_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_ROOT), "build", "native")


def _host_tag() -> str:
    """Host/ISA identifier folded into the cache key: the build uses
    -march=native, so a shared (e.g. NFS) cache dir across heterogeneous
    hosts must never serve another machine's binary (SIGILL)."""
    import hashlib
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return hashlib.sha256(" ".join(parts).encode()).hexdigest()[:8]


def _lib_path() -> str:
    """``build/native/libasr_native.<source digest>.<host tag>.so``: an
    edited source or another host builds a new library."""
    import hashlib

    with open(_SRC_PATH, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR,
                        f"libasr_native.{tag}.{_host_tag()}.so")


_LIB_PATH = _lib_path()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> None:
    """g++ into a per-process temporary path, then an atomic rename:
    racing processes each produce an identical binary. Raises with the
    compiler's stderr."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-o", tmp, _SRC_PATH],
            capture_output=True, text=True, timeout=300,
        )
        why = (f"g++ exit {proc.returncode}:\n{proc.stderr}"
               if proc.returncode else None)
    except (OSError, subprocess.TimeoutExpired) as e:
        why = str(e)
    if why is not None:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"building {_SRC_PATH} failed ({why})")
    os.replace(tmp, _LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """The library, built on first use; raises if it cannot be built or
    loaded (the same error again on every later call)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            raise RuntimeError(_build_error) from e
        lib.pack_waves.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.edit_distance_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.edit_distance_i32.restype = ctypes.c_int32
        lib.edit_distance_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32)
        ] * 4 + [ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.decode_wav_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.decode_wav_f32.restype = ctypes.c_int32
        lib.probe_wav.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.probe_wav.restype = ctypes.c_int32
        lib.decode_flac_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.decode_flac_f32.restype = ctypes.c_int32
        lib.probe_flac.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.probe_flac.restype = ctypes.c_int32
        batch_sig = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.load_pack_audio_batch.argtypes = batch_sig
        lib.load_pack_audio_batch.restype = ctypes.c_int32
        lib.load_pack_wav_batch.argtypes = batch_sig
        lib.load_pack_wav_batch.restype = ctypes.c_int32
        batch_sig_i16 = list(batch_sig)
        batch_sig_i16[5] = ctypes.POINTER(ctypes.c_int16)
        lib.load_pack_audio_batch_i16.argtypes = batch_sig_i16
        lib.load_pack_audio_batch_i16.restype = ctypes.c_int32
        lib.encode_flac_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.encode_flac_i16.restype = ctypes.c_int32
        _lib = lib
        return _lib


def pack_waves(
    waves: Sequence[np.ndarray], max_samples: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Native padded packing of float32 waveforms into [batch, max_samples]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(waves)
    waves32 = [np.ascontiguousarray(w, dtype=np.float32) for w in waves]
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for w in waves32]
    )
    lens = np.array([len(w) for w in waves32], dtype=np.int32)
    out_audio = np.empty((batch_size, max_samples), np.float32)
    out_lens = np.empty((batch_size,), np.int32)
    lib.pack_waves(
        ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        max_samples,
        batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_audio, out_lens


def decode_wav(path: str, expect_rate: int = 16000,
               max_samples: int = 16000 * 60 * 10) -> np.ndarray:
    """Decode a PCM16 / IEEE-float32 wav to mono float32 (native reader).

    Raises on open/format/rate errors so callers can fall back to the
    Python ``wave`` path.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_wav(path.encode(), ctypes.byref(rate),
                       ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_wav({path!r}) failed: rc={rc}")
    n = int(min(frames.value, max_samples))
    out = np.empty((n,), np.float32)
    got = lib.decode_wav_f32(
        path.encode(), expect_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got < 0:
        raise ValueError(f"decode_wav_f32({path!r}) failed: rc={got}")
    return out[:got]


def decode_flac(path: str, expect_rate: int = 16000,
                max_samples: int = 16000 * 60 * 10) -> np.ndarray:
    """Decode a FLAC file to mono float32 via the native subset decoder.

    Raises on open/format/rate errors (no Python-side FLAC fallback
    exists — the native lib is the only decoder in this image).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_flac(path.encode(), ctypes.byref(rate),
                        ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_flac({path!r}) failed: rc={rc}")
    n = int(min(frames.value, max_samples)) if frames.value > 0 else max_samples
    out = np.empty((n,), np.float32)
    got = lib.decode_flac_f32(
        path.encode(), expect_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got < 0:
        raise ValueError(f"decode_flac_f32({path!r}) failed: rc={got}")
    return out[:got]


def encode_flac(path: str, pcm: np.ndarray, sample_rate: int = 16000) -> None:
    """Encode mono int16 PCM to a subset FLAC file via the native encoder.

    The corpus-writer hot path (native/asr_native.cpp::encode_flac_i16):
    ~100x realtime vs the pure-Python coverage encoder's ~0.1x on this
    1-core host, which is what makes rendering a LibriSpeech-scale
    synthetic corpus feasible [VERDICT.md round-2 item 3].
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pcm16 = np.ascontiguousarray(pcm, dtype=np.int16)
    rc = lib.encode_flac_i16(
        path.encode(),
        pcm16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        pcm16.shape[0], sample_rate,
    )
    if rc != 0:
        raise ValueError(f"encode_flac_i16({path!r}) failed: rc={rc}")


def probe_flac(path: str) -> Tuple[int, int]:
    """Return (sample_rate, total_frames) from a FLAC STREAMINFO block."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_flac(path.encode(), ctypes.byref(rate),
                        ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_flac({path!r}) failed: rc={rc}")
    return int(rate.value), int(frames.value)


def load_pack_audio_batch(
    paths: Sequence[str], expect_rate: int, max_samples: int,
    batch_size: int, nthreads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused native read+decode+pack of wav/flac files into a bucket batch.

    Returns (audio [batch, max_samples] float32, lens [batch] int32).
    Raises on any per-file decode error (caller falls back to Python).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_audio = np.empty((batch_size, max_samples), np.float32)
    out_lens = np.empty((batch_size,), np.int32)
    rc = lib.load_pack_audio_batch(
        arr, n, expect_rate, max_samples, batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads,
    )
    if rc != 0:
        raise ValueError(f"load_pack_audio_batch failed: rc={rc}")
    return out_audio, out_lens


# Backward-compatible alias (pre-FLAC name).
load_pack_wav_batch = load_pack_audio_batch


def load_pack_audio_batch_i16(
    paths: Sequence[str], expect_rate: int, max_samples: int,
    batch_size: int, nthreads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """PCM16 device-transfer variant of :func:`load_pack_audio_batch`
    [data.transfer_dtype=int16]: rows land as int16 (exact inverse of the
    decoder's /32768 for 16-bit sources), halving host->device bytes.

    Returns (audio [batch, max_samples] int16, lens [batch] int32).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_audio = np.empty((batch_size, max_samples), np.int16)
    out_lens = np.empty((batch_size,), np.int32)
    rc = lib.load_pack_audio_batch_i16(
        arr, n, expect_rate, max_samples, batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads,
    )
    if rc != 0:
        raise ValueError(f"load_pack_audio_batch_i16 failed: rc={rc}")
    return out_audio, out_lens


def edit_distance_native(ref: List[str], hyp: List[str]) -> int:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    table: dict = {}
    def ids(seq):
        arr = np.empty(len(seq), np.int32)
        for i, t in enumerate(seq):
            arr[i] = table.setdefault(t, len(table))
        return arr
    r, h = ids(ref), ids(hyp)
    return int(
        lib.edit_distance_i32(
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(r),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(h),
        )
    )
