"""Parameters carried across from the JAX package, and back.

``params_from_jax`` takes the JAX model's ``params`` as nested dicts of
numpy arrays (``training/checkpoint.py::restore_checkpoint`` there, or
``model.init``) and returns the port's state dict; ``params_to_jax`` is
its inverse. The layouts are the same on both sides (flax Dense kernels
[in, out], ``l{n}_in_w`` [D, 8H] with the forward gates first, gate
order (i,f,g,o) with the forget bias inside the cell, the decoder's
parameters under their flax names), so the bridge maps names and copies
bits. An unknown name raises. It imports no flax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER_PARAM = re.compile(r"l\d+_(in_w|in_b|rec_f|rec_b)")
# models/decoder.py (JAX): the attention decoder's parameters, for every
# att_type and dec_layers.
_DECODER_PARAM = re.compile(
    r"embed|cell\d+_(wx|b|wh)|att_(q|k|b|v)|loc_(filter|proj)|out_(w|b)")
_DENSE = ("kernel", "bias")


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
                if set(leaf) != set(_DENSE):
                    raise KeyError(f"encoder/ctc_head has keys {sorted(leaf)}, "
                                   f"expected {list(_DENSE)}")
                for k in _DENSE:
                    state[f"encoder.ctc_head.{k}"] = _tensor(leaf[k])
            elif _LAYER_PARAM.fullmatch(name):
                state[f"encoder.{name}"] = _tensor(leaf)
            else:
                raise KeyError(
                    f"unknown encoder parameter {name!r} (the VGG2L front of "
                    "enc_type=vggblstm is not ported yet)")
    return state


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


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, Mapping):
        raise KeyError(f"expected an array, got a subtree with keys "
                       f"{sorted(leaf)}")
    return torch.from_numpy(np.array(leaf, copy=True))
