"""PyTorch port: the v1 BiLSTM layer over given projections
(``ops/bilstm.py::bilstm_pallas``, K7) on the CPU, where it runs its plain
versions, against the JAX package's ``ops/pallas_lstm.py::bilstm_pallas``
in interpret mode (forward, at its time chunks 4 and 8) and against
``jax.vjp`` of the JAX ``models/lstm.py::bilstm_scan`` (gradients).

Tolerances: f32 forward rtol/atol 1e-5 and gradients rtol 1e-4 / atol
1e-5, the JAX suite's own (tests/test_pallas_lstm.py). bf16 (projections,
streams and products in bf16, f32 carries): outputs and d(xg) are bf16
values, and a sum taken in another order can move a value across a bf16
rounding boundary, which the recurrence carries along: atol 2e-2 (the
card's K1 tolerance in chip_smoke.py) on the outputs, and on the
gradients 2e-2 of each one's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.models.lstm import bilstm_scan as jax_bilstm_scan
from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_pallas as jax_bilstm_pallas
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

TOL_BF16 = 2e-2


def _inputs(B=3, T=11, H=8, seed=0, lens=None):
    """tests/test_pallas_lstm.py's inputs, as numpy arrays."""
    rng = np.random.RandomState(seed)
    xg_f = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    xg_b = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    w_hf = rng.randn(H, 4 * H).astype(np.float32) * 0.2
    w_hb = rng.randn(H, 4 * H).astype(np.float32) * 0.2
    lens = np.array(lens if lens is not None else [T, 7, 3][:B], np.int32)
    return xg_f, xg_b, lens, w_hf, w_hb


def _port(arrays, dtype=torch.float32):
    xg_f, xg_b, lens, w_hf, w_hb = (torch.from_numpy(a) for a in arrays)
    return xg_f.to(dtype), xg_b.to(dtype), lens, w_hf, w_hb


def _jax(arrays, dtype=jnp.float32):
    xg_f, xg_b, lens, w_hf, w_hb = (jnp.asarray(a) for a in arrays)
    return xg_f.astype(dtype), xg_b.astype(dtype), lens, w_hf, w_hb


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


@pytest.mark.parametrize("tc", [4, 8])
def test_forward_matches_jax_kernel(tc):
    arrays = _inputs()
    ref = jax_bilstm_pallas(*_jax(arrays), jnp.float32, tc)
    got = K.bilstm_pallas(*_port(arrays))
    assert got.dtype == torch.float32 and got.shape == (3, 11, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_forward_unaligned_T_matches_jax_kernel():
    arrays = _inputs(T=13)
    ref = jax_bilstm_pallas(*_jax(arrays), jnp.float32, 8)
    got = K.bilstm_pallas(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_zero_and_full_lengths_match_jax_kernel():
    arrays = _inputs(T=19, lens=[0, 19, 5])
    ref = jax_bilstm_pallas(*_jax(arrays), jnp.float32, 8)
    got = K.bilstm_pallas(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert not got[0].any()  # a row of length 0 emits 0 everywhere
    assert not got[2, 5:].any()


@pytest.mark.parametrize("tc", [4, 8])
def test_bf16_forward_matches_jax_kernel(tc):
    arrays = _inputs(T=13)
    ref = jax_bilstm_pallas(*_jax(arrays, jnp.bfloat16), jnp.bfloat16, tc)
    got = K.bilstm_pallas(*_port(arrays, torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=TOL_BF16)


def _jax_grads(arrays, tgt, fn):
    xg_f, xg_b, lens, w_hf, w_hb = _jax(arrays)

    def loss(xf, xb, wf, wb):
        return jnp.sum(fn(xf, xb, lens, wf, wb) * tgt)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(xg_f, xg_b, w_hf, w_hb)


def _port_grads(arrays, tgt, dtype=torch.float32, compute_dtype=torch.float32):
    xg_f, xg_b, lens, w_hf, w_hb = _port(arrays, dtype)
    leaves = [t.detach().requires_grad_(True) for t in (xg_f, xg_b, w_hf, w_hb)]
    out = K.bilstm_pallas(leaves[0], leaves[1], lens, leaves[2], leaves[3],
                          compute_dtype)
    (out.float() * torch.from_numpy(tgt)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("lens", [None, [0, 10, 4]])
def test_gradients_match_jax_scan(lens):
    arrays = _inputs(T=10, lens=lens)
    tgt = np.random.RandomState(9).randn(3, 10, 16).astype(np.float32)
    ref = _jax_grads(arrays, tgt, jax_bilstm_scan)
    calls = K.bilstm_pallas_bwd_plain.calls
    got = _port_grads(arrays, tgt)
    assert K.bilstm_pallas_bwd_plain.calls == calls + 1
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_bf16_gradients_match_jax_kernel():
    """bf16 streams: the backward reads the rounded h and c streams, as
    the TPU kernel's does; d(xg) comes out in bf16 and dW in W's dtype."""
    arrays = _inputs(T=12)
    tgt = np.random.RandomState(8).randn(3, 12, 16).astype(np.float32)
    xg_f, xg_b, lens, w_hf, w_hb = _jax(arrays, jnp.bfloat16)

    def loss(xf, xb, wf, wb):
        out = jax_bilstm_pallas(xf, xb, lens, wf, wb, jnp.bfloat16, 4)
        return jnp.sum(out.astype(jnp.float32) * tgt)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xg_f, xg_b, w_hf, w_hb)
    got = _port_grads(arrays, tgt, torch.bfloat16, torch.bfloat16)
    for g, r in zip(got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        r = _f32(r)
        err = np.abs(_f32(g) - r).max() / np.abs(r).max()
        assert err <= TOL_BF16, err


@pytest.mark.parametrize("lens", [None, [0, 12, 5]])
def test_bf16_projections_f32_compute_match_jax_kernel(lens):
    """bf16 projections with an f32 compute dtype: the forward keeps h in
    f32 for its product and rounds the emitted streams; the backward
    recomputes the gates from the rounded h stream with an f32 product,
    gates the forward never formed (the pairing the card's kernels take
    through ``_recompute_gates``)."""
    arrays = _inputs(T=12, lens=lens)
    tgt = np.random.RandomState(7).randn(3, 12, 16).astype(np.float32)
    xg_f, xg_b, jl, w_hf, w_hb = _jax(arrays, jnp.bfloat16)
    ref_y = jax_bilstm_pallas(xg_f, xg_b, jl, w_hf, w_hb, jnp.float32, 4)

    def loss(xf, xb, wf, wb):
        out = jax_bilstm_pallas(xf, xb, jl, wf, wb, jnp.float32, 4)
        return jnp.sum(out.astype(jnp.float32) * tgt)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xg_f, xg_b, w_hf, w_hb)
    got_y = K.bilstm_pallas(*_port(arrays, torch.bfloat16), torch.float32)
    assert got_y.dtype == torch.bfloat16 and ref_y.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got_y), _f32(ref_y), rtol=0, atol=TOL_BF16)
    got = _port_grads(arrays, tgt, torch.bfloat16, torch.float32)
    for g, r in zip(got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        r = _f32(r)
        err = np.abs(_f32(g) - r).max() / np.abs(r).max()
        assert err <= TOL_BF16, err


def test_padded_steps_carry_no_gradient():
    """tests/test_pallas_lstm.py::test_gradient_masking: padded timesteps
    get no input-projection gradient; valid ones do."""
    xg_f, xg_b, _, w_hf, w_hb = _port(_inputs(B=2, T=9))
    lens = torch.tensor([9, 4], dtype=torch.int32)
    xf = xg_f.detach().requires_grad_(True)
    (K.bilstm_pallas(xf, xg_b, lens, w_hf, w_hb) ** 2).sum().backward()
    g = xf.grad.numpy()
    np.testing.assert_array_equal(g[1, 4:], 0.0)
    assert np.abs(g[1, :4]).sum() > 0


def test_plain_backward_matches_autograd_in_f64():
    """The explicit reverse sweep against autograd through the plain
    forward, in f64 (no rounding of the streams)."""
    arrays = _inputs(T=8, lens=[8, 5, 0])
    xg_f, xg_b, lens, w_hf, w_hb = (t.double() if t.is_floating_point() else t
                                    for t in _port(arrays))
    leaves = [t.requires_grad_(True) for t in (xg_f, xg_b, w_hf, w_hb)]
    dy = torch.randn(3, 8, 16, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    with torch.enable_grad():
        y = K.bilstm_scan(leaves[0], leaves[1], lens, leaves[2], leaves[3])
        ref = torch.autograd.grad(y, leaves, dy)
    y, c = K.bilstm_pallas_plain(xg_f.detach(), xg_b.detach(), lens,
                                 w_hf.detach(), w_hb.detach(), with_cell=True)
    got = K.bilstm_pallas_bwd_plain(xg_f.detach(), xg_b.detach(), lens,
                                    w_hf.detach(), w_hb.detach(), y, c, dy)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_kernels_refuse_cpu_tensors():
    xg_f, xg_b, lens, w_hf, w_hb = _port(_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        K.bilstm_pallas_kernel(xg_f, xg_b, lens, w_hf, w_hb)
    y = torch.zeros(3, 11, 16)
    with pytest.raises(ValueError, match="CUDA"):
        K.bilstm_pallas_bwd_kernel(lens, w_hf, w_hb, y, y,
                                   torch.zeros(3, 11, 64), y)
