"""PyTorch port, K2/K3: the CTC loss and its analytic gradient against the
JAX package and against ``torch.nn.functional.ctc_loss`` on the CPU.

The JAX ``ctc_loss`` runs its Pallas kernels (``alpha_pallas``,
``beta_post_pallas``) in interpret mode here, since ``ctc_supported``
admits these shapes; the port's CPU path is ``_alpha_plain`` and
``_beta_post_plain``. The batch covers repeated labels, a label_len of
0, an infeasible row (too many labels for its frames) and a pad row
(input_len 0). Tolerances: against JAX the same f32 formulas, where
only the exp/log implementations differ: rtol 1e-5 / atol 1e-5 on the
loss, atol 1e-5 on the gradient (its entries lie in [-1, 1]; measured
2e-6), 1e-6 on the recursions' values; against
``F.ctc_loss`` (another algorithm, in f32) rtol 1e-4 / atol 1e-4 on the
loss and atol 1e-5 on the gradient, on the rows both call feasible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops import ctc as jax_ctc
from gluon_e2e_asr_tpu.ops import pallas_ctc
from gluon_e2e_asr_tpu_torch.ops import ctc as C

torch.set_num_threads(1)

B, T, L, V = 6, 12, 4, 7
# rows: full, repeats, label_len 0, infeasible, pad (input_len 0), short
INPUT_LENS = np.array([12, 10, 6, 3, 0, 5], np.int32)
LABEL_LENS = np.array([4, 4, 0, 4, 0, 2], np.int32)


def _case(seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, V) * 2).astype(np.float32)
    labels = rng.randint(1, V, size=(B, L)).astype(np.int32)
    labels[1] = [3, 3, 5, 5]  # repeats need interposed blanks
    for b in range(B):
        labels[b, LABEL_LENS[b]:] = 0
    return logits, labels


def _jax(logits, labels):
    args = (jnp.asarray(INPUT_LENS), jnp.asarray(labels),
            jnp.asarray(LABEL_LENS))
    nll, vjp = jax.vjp(lambda x: jax_ctc.ctc_loss(x, *args), jnp.asarray(logits))
    (grad,) = vjp(jnp.ones((B,), jnp.float32))
    return np.asarray(nll), np.asarray(grad)


def _port(logits, labels):
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = C.ctc_loss(lg, torch.from_numpy(INPUT_LENS), torch.from_numpy(labels),
                     torch.from_numpy(LABEL_LENS))
    nll.sum().backward()
    return nll.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(seed):
    logits, labels = _case(seed)
    assert pallas_ctc.ctc_supported(T, B, 2 * L + 1)  # JAX takes K2/K3
    nll_ref, g_ref = _jax(logits, labels)
    nll, g = _port(logits, labels)
    np.testing.assert_allclose(nll, nll_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-5)


def test_infeasible_and_pad_rows_are_exactly_zero():
    logits, labels = _case()
    nll, g = _port(logits, labels)
    for b in (3, 4):  # infeasible, pad
        assert nll[b] == 0.0 and not g[b].any()
    assert np.all(nll[[0, 1, 2, 5]] > 0)


def test_matches_torch_ctc_loss():
    logits, labels = _case(2)
    nll, g = _port(logits, labels)
    lg = torch.from_numpy(logits).requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(lg, -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(INPUT_LENS).long(),
        torch.from_numpy(LABEL_LENS).long(), blank=0, reduction="none",
        zero_infinity=True)
    ref.sum().backward()
    rows = [0, 1, 2, 5]  # the feasible rows
    np.testing.assert_allclose(nll[rows], ref.detach().numpy()[rows],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g[rows], lg.grad.numpy()[rows], atol=1e-5)


def _lattice(logits, labels):
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    ext, skip, svalid, tmask = C._lattice(
        T, torch.from_numpy(INPUT_LENS), torch.from_numpy(labels),
        torch.from_numpy(LABEL_LENS), 0)
    return C._gather_states(logp, ext), tmask, skip, svalid


def test_recursions_match_the_jax_kernels():
    """alpha against ``alpha_pallas`` and the posterior against
    ``beta_post_pallas`` on the same lattice, rows of length > 0 (the
    TPU kernel leaves a length-0 row's alpha uninitialized)."""
    logits, labels = _case(3)
    emit, tmask, skip, svalid = _lattice(logits, labels)
    alpha = C.ctc_alpha(emit, tmask, skip, svalid)
    alpha_ref = np.asarray(pallas_ctc.alpha_pallas(
        *(jnp.asarray(t.numpy()) for t in (emit, tmask, skip, svalid))))
    live = INPUT_LENS > 0
    np.testing.assert_allclose(alpha.numpy()[:, live], alpha_ref[:, live],
                               rtol=1e-6, atol=1e-6)
    label_lens = torch.from_numpy(LABEL_LENS)
    ll = C._log_likelihood(alpha, label_lens)
    post = C.ctc_beta_post(emit, tmask, skip, svalid, 2 * label_lens, alpha, ll)
    post_ref = np.asarray(pallas_ctc.beta_post_pallas(
        *(jnp.asarray(t.numpy()) for t in (emit, tmask, skip, svalid,
                                           2 * label_lens, alpha, ll))))
    np.testing.assert_allclose(post.numpy(), post_ref, rtol=0, atol=1e-6)


def test_lattice_matches_jax():
    _, labels = _case()
    ext = C._expand_labels(torch.from_numpy(labels), 0)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(jax_ctc._expand_labels(jnp.asarray(labels), 0)))
    np.testing.assert_array_equal(
        C._transition_mask(ext, 0).numpy(),
        np.asarray(jax_ctc._transition_mask(jnp.asarray(ext.numpy()), 0)))
    np.testing.assert_array_equal(
        C._feasible(torch.from_numpy(INPUT_LENS), torch.from_numpy(labels),
                    torch.from_numpy(LABEL_LENS)).numpy(),
        np.asarray(jax_ctc._feasible(jnp.asarray(INPUT_LENS),
                                     jnp.asarray(labels),
                                     jnp.asarray(LABEL_LENS), 0)))


def test_cpu_tensors_take_the_plain_versions():
    logits, labels = _case()
    counts = (C._alpha_plain.calls, C._beta_post_plain.calls,
              C.ctc_alpha_kernel.launches, C.ctc_beta_post_kernel.launches)
    _port(logits, labels)
    assert (C._alpha_plain.calls, C._beta_post_plain.calls,
            C.ctc_alpha_kernel.launches, C.ctc_beta_post_kernel.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    logits, labels = _case()
    emit, tmask, skip, svalid = _lattice(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    with pytest.raises(ValueError, match="no implementation"):
        C.ctc_alpha(emit.to("meta"), tmask, skip, svalid)
