"""Render the synthetic utterance set to an on-disk LibriSpeech-shaped
corpus (.flac or .wav), for the real-corpus data path end to end.

The port's copy of the root ``tools/make_synth_corpus.py``, over the
port's manifest and its native FLAC encoder (``utils/native.py::
encode_flac``): the same flags, the same layout and, from the same seed,
the same files, byte for byte. The root tool falls back to the
pure-Python ``tools/flacenc.py`` when the native encoder fails; this one
raises. Layout, as LibriSpeech's, so ``build_librispeech_manifest``
walks it unchanged::

    <out>/train-clean-100/<spk>/<chap>/<spk>-<chap>-NNNN.flac
    <out>/train-clean-100/<spk>/<chap>/<spk>-<chap>.trans.txt
    <out>/dev-clean/...

- ``--text-mode english`` draws transcripts from the checked-in English
  pool instead of random characters.
- ``--durations librispeech`` draws utterance lengths from a
  LibriSpeech-like distribution (train ~N(12.7 s, 4 s) clipped
  [2, 16.6] s; dev ~N(7.4 s, 3.5 s) clipped [1.5, 16.6] s) instead of
  the fixed 8..26-char default.

Usage (``configs/ls100_full.yaml``'s corpus, cut to 512 + 64 utterances)::

    python -m gluon_e2e_asr_tpu_torch.tools.make_synth_corpus \
        --out corpora/ls100 --num-train 512 --num-dev 64 \
        --text-mode english --durations librispeech --jitter 0.04 \
        --noise 0.05 --pool-split sentence --seed 0
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import wave
from typing import List, Tuple

import numpy as np

from gluon_e2e_asr_tpu_torch.data.manifest import (
    _GAP_SEC,
    _SEG_SEC,
    Utterance,
    _sample_english_fragment,
    build_synthetic_manifest,
    english_pool_split,
    synth_waveform,
)
from gluon_e2e_asr_tpu_torch.data.tokenizer import DEFAULT_ALPHABET
from gluon_e2e_asr_tpu_torch.utils.native import encode_flac

UTTS_PER_CHAPTER = 25
CHAPTERS_PER_SPEAKER = 4

# LibriSpeech-like duration distributions (mean/std/min/max seconds).
# The real corpus is segmented to target ~10-17 s: train-clean-100 has
# essentially no mass above 17 s (docs/LIBRISPEECH.md's bucket bounds
# [4, 8, 12, 17] cover 99.9%), so the draw clips there — a corpus with a
# fat >17 s tail would make the recipe's buckets drop utterances the
# real corpus doesn't have.
_LS_DUR = {
    "train-clean-100": (12.7, 4.0, 2.0, 16.6),
    "dev-clean": (7.4, 3.5, 1.5, 16.6),
}


def _chars_for_duration(dur: float) -> int:
    return max(1, int(round((dur - _GAP_SEC) / (_SEG_SEC + _GAP_SEC))))


def _english_text_of_len(rng: np.random.RandomState, n_chars: int,
                         pool=None, forbid=None) -> str:
    """English text of ~n_chars, concatenating pool windows if needed
    (single pool sentences top out around 180 chars)."""
    parts: List[str] = []
    left = n_chars
    while left > 0:
        hi = min(left, 160)
        lo = max(1, hi - 12) if left > 12 else 1
        frag = _sample_english_fragment(rng, lo, hi, pool=pool,
                                        forbid_text=forbid)
        parts.append(frag)
        left -= len(frag) + 1  # +1 for the joining space
        if left < 4:
            break
    return " ".join(parts)[:n_chars].strip()


def _ls_duration_utts(split: str, num_utts: int, seed: int, text_mode: str,
                      noise: float, jitter: float,
                      pool_split: str = "none"):
    """Utterance list with LibriSpeech-like duration distribution."""
    mean, std, lo, hi = _LS_DUR[split]
    rng = np.random.RandomState(seed)
    letters = [c for c in DEFAULT_ALPHABET if c.isalpha()]
    pool = forbid = None
    if text_mode == "english" and pool_split == "sentence":
        side = "dev" if split.startswith("dev") else "train"
        pool = english_pool_split(side)
        if side == "dev":
            forbid = "\n".join(english_pool_split("train"))
    utts = []
    for i in range(num_utts):
        dur = float(np.clip(rng.normal(mean, std), lo, hi))
        n_chars = _chars_for_duration(dur)
        if text_mode == "english":
            text = _english_text_of_len(rng, n_chars, pool=pool,
                                        forbid=forbid)
        else:
            chars = [letters[rng.randint(len(letters))]
                     for _ in range(n_chars)]
            for j in range(6, n_chars, 7):
                chars[j] = " "
            text = "".join(chars).strip()
        real_dur = _GAP_SEC + len(text) * (_SEG_SEC + _GAP_SEC)
        utts.append(Utterance(
            utt_id=f"{split}-{i:05d}", text=text,
            duration=round(real_dur, 4), synth_seed=seed * 100003 + i,
            synth_noise=noise, synth_jitter=jitter,
        ))
    return utts


def utt_pcm(utt: Utterance, sample_rate: int = 16000) -> np.ndarray:
    """The 16-bit PCM (as int64) the corpus stores for ``utt``."""
    wav = synth_waveform(utt.text, utt.synth_seed, sample_rate,
                         noise=utt.synth_noise, jitter=utt.synth_jitter)
    return np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int64)


def utt_location(out_root: str, split: str, i: int, spk_base: int,
                 fmt: str) -> Tuple[str, str, str]:
    """(directory, utt id, audio path) of the split's ``i``-th utterance:
    ``<split>/<spk>/<chap>/<spk>-<chap>-NNNN.<fmt>``."""
    per_spk = UTTS_PER_CHAPTER * CHAPTERS_PER_SPEAKER
    spk = spk_base + i // per_spk
    chap = 1000 + (i % per_spk) // UTTS_PER_CHAPTER
    d = os.path.join(out_root, split, str(spk), str(chap))
    utt_id = f"{spk}-{chap}-{i % UTTS_PER_CHAPTER:04d}"
    return d, utt_id, os.path.join(d, f"{utt_id}.{fmt}")


def _write_one(job: Tuple[str, Utterance, str, int]) -> int:
    path, utt, fmt, sample_rate = job
    pcm = utt_pcm(utt, sample_rate)
    if fmt == "flac":
        # No fallback to a Python encoder: a failed build or encode raises.
        encode_flac(path, pcm.astype(np.int16), sample_rate)
    else:
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.astype("<i2").tobytes())
    return len(pcm)


def render_split(
    out_root: str,
    split: str,
    num_utts: int,
    seed: int,
    fmt: str,
    sample_rate: int,
    workers: int,
    spk_base: int,
    text_mode: str = "random",
    durations: str = "fixed",
    noise: float = 0.003,
    jitter: float = 0.01,
    pool_split: str = "none",
) -> int:
    if durations == "librispeech":
        utts = _ls_duration_utts(split, num_utts, seed, text_mode,
                                 noise, jitter, pool_split=pool_split)
    else:
        side = "all"
        if pool_split == "sentence":
            side = "dev" if split.startswith("dev") else "train"
        utts = build_synthetic_manifest(num_utts, seed, prefix=split,
                                        text_mode=text_mode, noise=noise,
                                        jitter=jitter, split=side)
    jobs: List[Tuple[str, Utterance, str, int]] = []
    trans: dict = {}
    for i, u in enumerate(utts):
        d, utt_id, path = utt_location(out_root, split, i, spk_base, fmt)
        os.makedirs(d, exist_ok=True)
        jobs.append((path, u, fmt, sample_rate))
        chapter = utt_id.rsplit("-", 1)[0]
        trans.setdefault(os.path.join(d, f"{chapter}.trans.txt"), []).append(
            f"{utt_id} {u.text.upper()}"
        )
    for tpath, lines in trans.items():
        with open(tpath, "w") as f:
            f.write("\n".join(lines) + "\n")
    if workers > 1:
        # spawn, not fork: the caller may hold threads (a trainer, CUDA).
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            samples = pool.map(_write_one, jobs, chunksize=8)
    else:
        samples = [_write_one(j) for j in jobs]
    return int(sum(samples))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num-train", type=int, default=960)
    p.add_argument("--num-dev", type=int, default=128)
    p.add_argument("--format", choices=["flac", "wav"], default="flac")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    p.add_argument("--text-mode", choices=["random", "english"],
                   default="random")
    p.add_argument("--durations", choices=["fixed", "librispeech"],
                   default="fixed",
                   help="'librispeech' draws LibriSpeech-like utterance "
                        "durations (train ~12.7 s, dev ~7.4 s means)")
    p.add_argument("--noise", type=float, default=0.003)
    p.add_argument("--jitter", type=float, default=0.01)
    p.add_argument("--pool-split", choices=["none", "sentence"],
                   default="none",
                   help="'sentence' draws train/dev transcripts from the "
                        "disjoint english_pool_split sides (dev windows "
                        "additionally rejected if present in train-side "
                        "text) — the round-4 leakage-proof fixture rule")
    args = p.parse_args(argv)

    total = 0
    for split, num, seed_off, spk in (
        ("train-clean-100", args.num_train, 0, 100),
        ("dev-clean", args.num_dev, 1, 900),
    ):
        total += render_split(
            args.out, split, num, args.seed + seed_off, args.format,
            args.sample_rate, args.workers, spk_base=spk,
            text_mode=args.text_mode, durations=args.durations,
            noise=args.noise, jitter=args.jitter,
            pool_split=args.pool_split,
        )
    hours = total / args.sample_rate / 3600.0
    print(f"wrote {args.num_train}+{args.num_dev} utts "
          f"({hours:.2f} h of audio) to {args.out} as .{args.format}")
    return {"num_train": args.num_train, "num_dev": args.num_dev,
            "samples": total, "hours": hours}


if __name__ == "__main__":
    main()
