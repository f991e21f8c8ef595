"""Parameters carried across from the JAX package, and back.

``params_from_jax`` takes the JAX model's ``params`` as nested dicts of
numpy arrays (``training/checkpoint.py::restore_checkpoint`` there, or
``model.init``) and returns the port's state dict; ``params_to_jax`` is
its inverse. The layouts are the same on both sides (flax Dense kernels
[in, out], ``l{n}_in_w`` [D, 8H] with the forward gates first, gate
order (i,f,g,o) with the forget bias inside the cell, the decoder's
parameters under their flax names), so the bridge maps names and copies
bits. An unknown name raises. It imports no flax.

``read_jax_checkpoint`` reads the JAX trainer's checkpoint file (a flax
msgpack snapshot, ``training/checkpoint.py`` there) with its own small
msgpack reader, so that a JAX checkpoint converts where neither flax nor
the ``msgpack`` package is installed.

The external LM (``models/lm.py``) has its own pair,
``lm_params_from_jax`` / ``lm_params_to_jax``: the flax ``LSTMLM``'s
parameters are a flat tree whose names are the port's state-dict keys.
``read_jax_lm_checkpoint`` reads a JAX ``train_lm.py`` checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LAYER_PARAM = re.compile(r"l\d+_(in_w|in_b|rec_f|rec_b)")
# models/encoder.py (JAX): VGG2L's convs, encoder/vgg/conv{stage}_{k}.
_VGG_CONV = re.compile(r"conv\d+_\d+")
# models/decoder.py (JAX): the attention decoder's parameters, for every
# att_type and dec_layers.
_DECODER_PARAM = re.compile(
    r"embed|cell\d+_(wx|b|wh)|att_(q|k|b|v)|loc_(filter|proj)|out_(w|b)")
_DENSE = ("kernel", "bias")
# models/lm.py (JAX): the LSTM LM's parameters.
_LM_PARAM = re.compile(r"embed|cell\d+_(wx|b|wh)|out_(w|b)")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``params`` tree -> the port's ``ASRModel`` state dict."""
    state: Dict[str, torch.Tensor] = {}
    for top, sub in tree.items():
        if top == "decoder":
            for name, leaf in sub.items():
                if not _DECODER_PARAM.fullmatch(name):
                    raise KeyError(f"unknown decoder parameter {name!r}")
                state[f"decoder.{name}"] = _tensor(leaf)
            continue
        if top != "encoder":
            raise KeyError(f"unknown parameter subtree {top!r}")
        for name, leaf in sub.items():
            if name == "ctc_head":
                _dense(state, "encoder/ctc_head", "encoder.ctc_head", leaf)
            elif name == "vgg" and isinstance(leaf, Mapping):
                for conv, kb in leaf.items():
                    if not _VGG_CONV.fullmatch(conv):
                        raise KeyError(f"unknown VGG2L parameter {conv!r}")
                    _dense(state, f"encoder/vgg/{conv}",
                           f"encoder.vgg.{conv}", kb)
            elif _LAYER_PARAM.fullmatch(name):
                state[f"encoder.{name}"] = _tensor(leaf)
            else:
                raise KeyError(f"unknown encoder parameter {name!r}")
    return state


def _dense(state: Dict[str, torch.Tensor], where: str, prefix: str,
           leaf) -> None:
    """A flax ``Dense`` or ``Conv`` subtree: exactly {kernel, bias}."""
    if not isinstance(leaf, Mapping) or set(leaf) != set(_DENSE):
        keys = sorted(leaf) if isinstance(leaf, Mapping) else type(leaf)
        raise KeyError(f"{where} has keys {keys}, expected {list(_DENSE)}")
    for k in _DENSE:
        state[f"{prefix}.{k}"] = _tensor(leaf[k])


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> a JAX ``params`` tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def lm_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``LSTMLM`` ``params`` tree -> the port's ``LSTMLM`` state
    dict (the same names, the same layouts)."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if not _LM_PARAM.fullmatch(name):
            raise KeyError(f"unknown LM parameter {name!r}")
        state[name] = _tensor(leaf)
    return state


def lm_params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``LSTMLM`` state dict -> a JAX ``params`` tree of numpy
    arrays."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        if not _LM_PARAM.fullmatch(name):
            raise KeyError(f"unknown LM parameter {name!r}")
        tree[name] = value.detach().cpu().numpy()
    return tree


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, Mapping):
        raise KeyError(f"expected an array, got a subtree with keys "
                       f"{sorted(leaf)}")
    return torch.from_numpy(np.array(leaf, copy=True))


# ---------------------------------------------------------------------------
# The JAX trainer's checkpoint files
# ---------------------------------------------------------------------------

# flax.serialization's msgpack extension types.
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder for what flax writes: maps, arrays, strings,
    binaries, numbers, nil, booleans, and extension types (arrays and
    numpy scalars)."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def _take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def _num(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._num("BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._num("BHI"[b - 0xC7])
            return self._ext(self._num("b"), n)
        if b in (0xCA, 0xCB):
            return self._num("fd"[b - 0xCA])
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self._num("BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1..16
            code = self._num("b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._take(self._num("BHI"[b - 0xD9])).decode()
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.read() for _ in range(self._num("HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._num("HI"[b - 0xDE]))
        raise ValueError(f"msgpack type byte {b:#x} not supported")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        inner = _Reader(self._take(n)).read()
        if code == _EXT_NDARRAY:
            shape, dtype, data = inner
            return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()
        if code == _EXT_NPSCALAR:
            dtype, data = inner
            return np.frombuffer(data, dtype=np.dtype(dtype))[0]
        raise ValueError(f"flax msgpack extension {code} not supported")


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[tuple],
                                            Dict[str, Any]]:
    """(params tree of numpy arrays, cmvn stats or None, meta) of a JAX
    trainer checkpoint (``<dir>/ckpt_<step>.msgpack`` with its ``.json``
    sidecar). Feed the tree to ``params_from_jax``."""
    with open(path, "rb") as f:
        payload = _Reader(f.read()).read()
    cmvn = payload.get("cmvn")
    if cmvn is not None:
        cmvn = tuple(np.asarray(x) for x in cmvn)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return payload["state"]["params"], cmvn, meta


def read_jax_lm_checkpoint(path: str) -> Dict[str, Any]:
    """The params tree (numpy arrays) of a JAX ``train_lm.py`` checkpoint
    (``models/lm.py::save_lm`` there: a flax msgpack whose top level is
    ``{"params": ...}``). Feed it to ``lm_params_from_jax``."""
    with open(path, "rb") as f:
        payload = _Reader(f.read()).read()
    if not isinstance(payload, dict) or set(payload) != {"params"}:
        keys = sorted(payload) if isinstance(payload, dict) else type(payload)
        raise KeyError(f"{path}: top level {keys}, expected ['params']")
    return payload["params"]
