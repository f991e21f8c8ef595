"""PyTorch port: the attention branch's losses against the JAX package.

``make_decoder_io`` is integer bookkeeping and must agree exactly; the
label-smoothed CE is an f32 log-softmax, a gather and a mean on both
sides: the loss within rtol 1e-6 (f32 rounding of the vocabulary sums)
and the accuracy exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.losses import ce_label_smoothing_loss as jax_ce
from gluon_e2e_asr_tpu.ops.losses import make_decoder_io as jax_io
from gluon_e2e_asr_tpu_torch.ops.losses import (
    ce_label_smoothing_loss, make_decoder_io)

torch.set_num_threads(1)


def _labels(seed=0, B=5, L=7, V=13):
    rng = np.random.RandomState(seed)
    label_len = np.array([7, 3, 0, 5, 1], np.int32)[:B]
    labels = rng.randint(4, V, size=(B, L)).astype(np.int32)
    labels *= np.arange(L)[None] < label_len[:, None]
    return labels, label_len


@pytest.mark.parametrize("sos,eos", [(2, 3), (1, 9)])
def test_make_decoder_io_matches_jax_exactly(sos, eos):
    labels, label_len = _labels()
    ref = jax_io(jnp.asarray(labels), jnp.asarray(label_len), sos, eos)
    got = make_decoder_io(torch.from_numpy(labels), torch.from_numpy(label_len),
                          sos, eos)
    for name, g, r in zip(("tokens_in", "targets", "tgt_mask"), got, ref):
        assert g.dtype == torch.from_numpy(np.array(r)).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_label_smoothing_matches_jax(smoothing):
    labels, label_len = _labels(1)
    _, targets, mask = jax_io(jnp.asarray(labels), jnp.asarray(label_len), 2, 3)
    targets, mask = np.array(targets), np.array(mask)
    mask[3] = 0.0  # a pad row, as the train step masks it
    rng = np.random.RandomState(2)
    logits = (rng.randn(*targets.shape, 13) * 3).astype(np.float32)
    logits[0, 1, :] = logits[0, 1, 0]  # a tie: the first maximum wins
    loss, acc = jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                       jnp.asarray(mask), smoothing)
    got_loss, got_acc = ce_label_smoothing_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(mask), smoothing)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss), rtol=1e-6)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    assert got_loss[3] == 0 and got_acc[3] == 0


def test_ce_gradient_matches_jax():
    import jax

    labels, label_len = _labels(3)
    _, targets, mask = jax_io(jnp.asarray(labels), jnp.asarray(label_len), 2, 3)
    logits = np.random.RandomState(4).randn(*targets.shape, 13).astype(np.float32)
    ref = jax.grad(lambda lg: jax_ce(lg, targets, mask, 0.1)[0].sum())(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    ce_label_smoothing_loss(lg, torch.from_numpy(np.array(targets)),
                            torch.from_numpy(np.array(mask)), 0.1)[0].sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
