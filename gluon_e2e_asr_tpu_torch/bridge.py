"""Parameters carried across from the JAX package, and back.

``params_from_jax`` takes the JAX model's ``params`` as nested dicts of
numpy arrays (``training/checkpoint.py::restore_checkpoint`` there, or
``model.init``) and returns the port's state dict; ``params_to_jax`` is
its inverse. The layouts are the same on both sides (flax Dense kernels
[in, out], ``l{n}_in_w`` [D, 8H] with the forward gates first, gate
order (i,f,g,o) with the forget bias inside the cell), so the bridge
maps names and copies bits. It imports no flax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER_PARAM = re.compile(r"l\d+_(in_w|in_b|rec_f|rec_b)")
_DENSE = ("kernel", "bias")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``params`` tree -> the port's ``ASRModel`` state dict."""
    state: Dict[str, torch.Tensor] = {}
    for top, sub in tree.items():
        if top == "decoder":
            # The attention decoder is mapped by the port's decoder, which
            # arrives with beam search; greedy CTC decoding does not use it.
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
    return torch.from_numpy(np.array(leaf, copy=True))
