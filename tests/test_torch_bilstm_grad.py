"""PyTorch port, K1-bwd: the gradient of ``bilstm_fused`` against the JAX
package on the CPU.

The JAX reference is ``jax.vjp`` of ``ops/pallas_lstm.py::bilstm_fused``,
whose backward Pallas kernel (``_v2_bwd_kernel``) runs in interpret mode
here. The port's CPU path is ``BiLSTMFused`` with the plain forward and
``bilstm_fused_bwd_plain``. Inputs come from a numpy seed and go to both
packages; ragged lengths include len = T and len = 1, and H > 1 so a
gate-column mix-up cannot pass.

Tolerances: f32 rtol 1e-4 / atol 1e-5, the JAX suite's own for
pallas-against-scan gradients (tests/test_encoder_pallas_lstm.py). bf16:
the products round their operands to bf16 on both sides, but a sum-order
difference can flip one rounding of h or dg, 2^-8 relative, and the flip
travels through the recursion: 3e-2 of the largest magnitude of each
gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

B, T, H, D = 4, 12, 6, 5  # T is not a multiple of the TPU time chunk
LENS = np.array([12, 7, 1, 4], np.int32)
NAMES = ("dx", "dw_x", "db", "dw_hf", "dw_hb")


def _layer(seed=0):
    rng = np.random.RandomState(seed)
    a = {
        "x": rng.randn(B, T, D).astype(np.float32),
        "lens": LENS,
        "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
        "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
        "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
    }
    dy = rng.randn(B, T, 2 * H).astype(np.float32)
    return a, dy


def _jax_grads(a, dy, cd):
    x, lens, w_x, b_x, w_hf, w_hb = (jnp.asarray(v) for v in a.values())
    y, vjp = jax.vjp(
        lambda x, w_x, b_x, w_hf, w_hb: jax_bilstm_fused(
            x, lens, w_x, b_x, w_hf, w_hb, jnp.dtype(cd), 8),
        x, w_x, b_x, w_hf, w_hb)
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _port_grads(a, dy, cd, dtype=torch.float32):
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    for i in (0, 2, 3, 4, 5):
        ins[i] = ins[i].to(dtype).requires_grad_(True)
    y = K.bilstm_fused(*ins, compute_dtype=getattr(torch, cd))
    grads = torch.autograd.grad(y, [ins[i] for i in (0, 2, 3, 4, 5)],
                                torch.from_numpy(dy).to(dtype))
    return y.detach().numpy(), [g.numpy() for g in grads]


def test_f32_gradients_match_jax_vjp():
    a, dy = _layer()
    y_ref, ref = _jax_grads(a, dy, "float32")
    y, got = _port_grads(a, dy, "float32")
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_gradients_match_jax_vjp():
    a, dy = _layer(1)
    _, ref = _jax_grads(a, dy, "bfloat16")
    _, got = _port_grads(a, dy, "bfloat16")
    for name, g, r in zip(NAMES, got, ref):
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= 3e-2, (name, err)


@pytest.mark.parametrize("round_xg", [False, True])
def test_plain_backward_matches_autograd_through_plain_forward(round_xg):
    """The explicit reverse-time loop against autograd through the
    forward's time loop, in f64: exact up to rounding, except that with
    ``round_xg`` autograd casts the cotangent of xg back through the
    rounding to f32 (the compute dtype), 2^-24 relative."""
    a, dy = _layer(2)
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    for i in (0, 2, 3, 4, 5):
        ins[i] = ins[i].double().requires_grad_(True)
    dyt = torch.from_numpy(dy).double()
    leaves = [ins[i] for i in (0, 2, 3, 4, 5)]
    y = K.bilstm_fused_plain(*ins, round_xg=round_xg)
    ref = torch.autograd.grad(y, leaves, dyt)
    with torch.no_grad():
        y, c = K.bilstm_fused_plain(*ins, round_xg=round_xg, with_cell=True)
        got = K.bilstm_fused_bwd_plain(*ins, y, c, dyt, round_xg=round_xg)
    tol = dict(rtol=1e-6, atol=1e-7) if round_xg else dict(rtol=1e-10,
                                                            atol=1e-12)
    for name, g, r in zip(NAMES, got, ref):
        torch.testing.assert_close(g, r, **tol, msg=name)


def test_gradcheck_of_the_function():
    rng = np.random.RandomState(3)
    b, t, d, h = 2, 4, 3, 2
    lens = torch.tensor([4, 2], dtype=torch.int32)
    leaves = [torch.tensor(rng.randn(*s) * 0.5, dtype=torch.float64,
                           requires_grad=True)
              for s in ((b, t, d), (d, 8 * h), (8 * h,), (h, 4 * h), (h, 4 * h))]
    assert torch.autograd.gradcheck(
        lambda x, w_x, b_x, w_hf, w_hb: K.BiLSTMFused.apply(
            x, lens, w_x, b_x, w_hf, w_hb, torch.float32, False),
        leaves)


def test_cpu_gradient_takes_the_plain_versions():
    a, dy = _layer()
    counts = (K.bilstm_fused_plain.calls, K.bilstm_fused_bwd_plain.calls,
              K.bilstm_fused_kernel.launches, K.bilstm_fused_bwd_kernel.launches)
    _port_grads(a, dy, "float32")
    assert (K.bilstm_fused_plain.calls, K.bilstm_fused_bwd_plain.calls,
            K.bilstm_fused_kernel.launches,
            K.bilstm_fused_bwd_kernel.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    a, dy = _layer()
    x, lens, w_x, b_x, w_hf, w_hb = (torch.from_numpy(np.ascontiguousarray(v))
                                     for v in a.values())
    y = torch.zeros(B, T, 2 * H)
    with pytest.raises(ValueError, match="CUDA"):
        K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, y,
                                  torch.zeros(B, T, 8 * H), torch.from_numpy(dy))


def test_transpose_quads_layout():
    w = torch.arange(H * 4 * H, dtype=torch.float32).reshape(H, 4 * H)
    flat = K._transpose_quads(w)
    for u in (0, 2, H - 1):
        for j in (0, 5, 4 * H - 1):
            q, e = divmod(j, 4)
            assert flat[(q * H + u) * 4 + e] == w[u, j]


def test_training_forward_cell_stream_is_zero_past_lens():
    a, _ = _layer()
    y, c = K.bilstm_fused_plain(*(torch.from_numpy(np.ascontiguousarray(v))
                                  for v in a.values()), with_cell=True)
    for b, n in enumerate(LENS):
        assert not c[b, n:].any() and not y[b, n:].any()
        assert c[b, :n].abs().min() > 0
