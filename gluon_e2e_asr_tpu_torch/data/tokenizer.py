"""Tokenizers / vocabularies: character and subword (BPE) units.

The port's own copy of ``gluon_e2e_asr_tpu/data/tokenizer.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_data.py`` holds the
two to the same results.

Reference-side realization: a Python dict mapping characters to label
ids [SURVEY.md §2.1 #2, INFERRED-high]. CTC requires a blank symbol and
the attention decoder requires sos/eos [BASELINE.json:L7,L9]. The
subword tokenizer extends the same id contract to BPE units — the ASR
family this stack rebuilds commonly trains LibriSpeech recipes on
subword targets, and the batched beam already carries a chunked
partial-CTC scoring path sized for BPE vocabularies
(``decoding/beam.py``, ``config.py ctc_score_candidates``).

Id layout (deterministic, serialized with checkpoints):
  0 = <blank>   (CTC blank; also the label-pad id — always masked)
  1 = <unk>
  2 = <sos>
  3 = <eos>
  4.. = units (char: alphabet sorted; bpe: chars sorted, then merged
        pieces in learned-merge order)
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, List, Sequence, Tuple

BLANK = "<blank>"
UNK = "<unk>"
SOS = "<sos>"
EOS = "<eos>"

DEFAULT_ALPHABET = " 'abcdefghijklmnopqrstuvwxyz"


class CharTokenizer:
    """Maps transcripts to int label sequences and back."""

    def __init__(self, alphabet: str = DEFAULT_ALPHABET):
        self.specials = [BLANK, UNK, SOS, EOS]
        self.alphabet = "".join(sorted(set(alphabet)))
        self.itos: List[str] = list(self.specials) + list(self.alphabet)
        self.stoi: Dict[str, int] = {s: i for i, s in enumerate(self.itos)}

    # --- special ids -----------------------------------------------------
    @property
    def blank_id(self) -> int:
        return self.stoi[BLANK]

    @property
    def unk_id(self) -> int:
        return self.stoi[UNK]

    @property
    def sos_id(self) -> int:
        return self.stoi[SOS]

    @property
    def eos_id(self) -> int:
        return self.stoi[EOS]

    @property
    def pad_id(self) -> int:
        # Labels are padded with blank and masked by length everywhere.
        return self.blank_id

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    # --- encode / decode --------------------------------------------------
    def encode(self, text: str) -> List[int]:
        text = text.lower()
        return [self.stoi.get(ch, self.unk_id) for ch in text]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in (self.blank_id, self.sos_id, self.eos_id):
                continue
            out.append(self.itos[i] if 0 <= i < len(self.itos) else UNK)
        return "".join(out)

    @classmethod
    def build_from_texts(cls, texts: Iterable[str]) -> "CharTokenizer":
        chars = set()
        for t in texts:
            chars.update(t.lower())
        return cls("".join(sorted(chars)))

    # --- serialization (stored beside checkpoints) -------------------------
    def to_json(self) -> str:
        return json.dumps({"alphabet": self.alphabet})

    @classmethod
    def from_json(cls, blob: str) -> "CharTokenizer":
        return cls(json.loads(blob)["alphabet"])

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Subword (BPE) tokenizer
# ---------------------------------------------------------------------------

# SentencePiece-style word marker: every word is prefixed with it, so
# spacing survives the id round trip without a dedicated space token.
WORD_MARK = "▁"  # ▁


def _merge_all(syms: Tuple[str, ...], pair: Tuple[str, str]) -> Tuple[str, ...]:
    """Merge every left-to-right occurrence of ``pair`` in ``syms``."""
    out: List[str] = []
    i, n = 0, len(syms)
    a, b = pair
    while i < n:
        if i + 1 < n and syms[i] == a and syms[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(syms[i])
            i += 1
    return tuple(out)


class SubwordTokenizer:
    """Byte-pair-encoding subword units with the CharTokenizer id contract.

    Deterministic: merge selection breaks count ties on the
    lexicographically smallest pair, so the same corpus always yields
    the same vocabulary regardless of text order. Words never merge
    across the ``WORD_MARK`` boundary because each word is segmented
    independently.
    """

    def __init__(self, chars: str, merges: Sequence[Tuple[str, str]]):
        self.specials = [BLANK, UNK, SOS, EOS]
        # Base inventory: single characters (the marker included), sorted.
        self.chars = "".join(sorted(set(chars) | {WORD_MARK}))
        self.merges: List[Tuple[str, str]] = [tuple(m) for m in merges]
        pieces = [a + b for a, b in self.merges]
        self.itos: List[str] = list(self.specials) + list(self.chars) + pieces
        self.stoi: Dict[str, int] = {s: i for i, s in enumerate(self.itos)}
        self._ranks: Dict[Tuple[str, str], int] = {
            m: r for r, m in enumerate(self.merges)
        }
        self._word_cache: Dict[str, List[int]] = {}

    # --- special ids -------------------------------------------------------
    @property
    def blank_id(self) -> int:
        return self.stoi[BLANK]

    @property
    def unk_id(self) -> int:
        return self.stoi[UNK]

    @property
    def sos_id(self) -> int:
        return self.stoi[SOS]

    @property
    def eos_id(self) -> int:
        return self.stoi[EOS]

    @property
    def pad_id(self) -> int:
        return self.blank_id

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    # --- encode / decode ----------------------------------------------------
    def _segment(self, word: str) -> Tuple[str, ...]:
        """Apply learned merges (lowest rank first) to ``▁ + word``."""
        syms: Tuple[str, ...] = (WORD_MARK,) + tuple(word)
        while len(syms) > 1:
            best_rank, best_pair = None, None
            for p in zip(syms, syms[1:]):
                r = self._ranks.get(p)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pair = r, p
            if best_pair is None:
                break
            syms = _merge_all(syms, best_pair)
        return syms

    def encode_word(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is None:
            ids = [self.stoi.get(s, self.unk_id) for s in self._segment(word)]
            self._word_cache[word] = ids
        return list(ids)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for w in text.lower().split():
            out.extend(self.encode_word(w))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if i in (self.blank_id, self.sos_id, self.eos_id):
                continue
            pieces.append(self.itos[i] if 0 <= i < len(self.itos) else UNK)
        return "".join(pieces).replace(WORD_MARK, " ").strip()

    # --- training ------------------------------------------------------------
    @classmethod
    def build_from_texts(
        cls, texts: Iterable[str], vocab_size: int
    ) -> "SubwordTokenizer":
        """Learn BPE merges targeting ``vocab_size`` total ids.

        Greedy count-based merging over word types weighted by frequency
        (the classic subword-nmt procedure). Stops early when no adjacent
        pair occurs at least twice.
        """
        from collections import Counter

        words: Counter = Counter()
        chars = set()
        for t in texts:
            for w in t.lower().split():
                words[w] += 1
                chars.update(w)
        chars_s = "".join(sorted(chars | {WORD_MARK}))
        n_base = 4 + len(chars_s)  # specials + single chars
        word_syms: Dict[str, Tuple[str, ...]] = {
            w: (WORD_MARK,) + tuple(w) for w in words
        }
        merges: List[Tuple[str, str]] = []
        while n_base + len(merges) < vocab_size:
            pairs: Counter = Counter()
            for w, count in words.items():
                syms = word_syms[w]
                for p in zip(syms, syms[1:]):
                    pairs[p] += count
            if not pairs:
                break
            best, best_count = min(
                pairs.items(), key=lambda kv: (-kv[1], kv[0])
            )
            if best_count < 2:
                break
            merges.append(best)
            word_syms = {
                w: _merge_all(s, best) for w, s in word_syms.items()
            }
        return cls(chars_s, merges)

    # --- serialization --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "type": "bpe",
            "chars": self.chars,
            "merges": [list(m) for m in self.merges],
        })

    @classmethod
    def from_json(cls, blob: str) -> "SubwordTokenizer":
        d = json.loads(blob)
        return cls(d["chars"], [tuple(m) for m in d["merges"]])

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Dispatch helpers
# ---------------------------------------------------------------------------

def tokenizer_from_json(blob: str):
    """Rebuild whichever tokenizer a checkpoint's ``vocab`` meta holds.

    Backward compatible: pre-subword checkpoints serialized only
    ``{"alphabet": ...}`` with no type tag.
    """
    d = json.loads(blob)
    if d.get("type") == "bpe":
        return SubwordTokenizer.from_json(blob)
    return CharTokenizer.from_json(blob)


def build_tokenizer(config, texts: Iterable[str]):
    """Construct the configured tokenizer (``data.tokenizer``).

    ``char`` ignores ``texts`` (fixed default alphabet, the historical
    behavior); ``bpe`` learns merges from them deterministically, so
    train-time construction and a resume over the same manifest agree
    bit-for-bit (the trainer additionally cross-checks the checkpoint's
    vocab fingerprint on resume).
    """
    kind = config.data.tokenizer
    if kind == "char":
        return CharTokenizer()
    if kind == "bpe":
        return SubwordTokenizer.build_from_texts(
            texts, config.data.bpe_vocab_size)
    raise ValueError(f"unknown data.tokenizer {kind!r} (char|bpe)")
