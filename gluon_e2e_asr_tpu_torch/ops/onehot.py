"""Sums over an index taken as one-hot products, in a fixed order.

On the card, PyTorch's ``index_add_``, ``scatter_add_`` and the backward
of an indexing gather (``table[ids]``) add into one address with float
atomics, in an order that varies from run to run: two identical training
steps then end with different weights. The JAX package writes these sums
as one-hot products (``ops/ctc.py``'s posterior, ``jax.nn.one_hot`` and
an einsum) or as XLA scatters, whose order on the TPU is fixed. Here each
is a matrix product with a one-hot matrix, which cuBLAS sums in the same
order on every run; the vocabularies (at most a few hundred entries)
keep the one-hot matrices small.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rows_sum(ids: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """out [n, E] with out[v] the sum of the rows src[i] [N, E] whose
    ids[i] [N] is v: ``zeros(n, E).index_add_(0, ids, src)`` as a one-hot
    product."""
    onehot = F.one_hot(ids.long(), n).to(src.dtype)  # [N, n]
    return onehot.T @ src


class _Embed(torch.autograd.Function):
    """``table[ids]`` whose gradient is ``rows_sum``, not an atomic
    scatter."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        return rows_sum(ids.reshape(-1), g, ctx.rows), None


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` [V, E] at ``ids`` (any shape): [*ids.shape,
    E], with a gradient to ``table`` summed in a fixed order."""
    if not torch.is_grad_enabled() or not table.requires_grad:
        return table[ids.long()]
    return _Embed.apply(table, ids)
