"""PyTorch port, K1-fwd: the plain version of ``bilstm_fused`` and the
LSTM time loop against the JAX package on the CPU.

The JAX ``bilstm_fused`` runs its Pallas kernel in interpret mode here,
as it always does off a TPU. Inputs come from a numpy seed and go to
both packages. Tolerances: f32 is the JAX suite's own between its LSTM
paths (tests/test_bilstm_fused.py); in bf16 h is rounded to bf16 every
step, and a sum-order difference can flip one rounding (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.models.lstm import bilstm_scan as jax_bilstm_scan
from gluon_e2e_asr_tpu.models.lstm import lstm_cell_step as jax_cell_step
from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.models.lstm import bilstm_scan, lstm_cell_step
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

B, T, H, D = 3, 19, 8, 12  # T is not a multiple of the TPU time chunk
LENS = np.array([19, 7, 1], np.int32)
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0.0, atol=1e-2)}


def _layer(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(B, T, D).astype(np.float32),
        "lens": LENS,
        "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
        "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
        "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
    }


def _torch(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in a.values())


def _jax(a):
    return tuple(jnp.asarray(v) for v in a.values())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_matches_jax_bilstm_fused(cd):
    """lstm_impl: pallas semantics (f32 projection, masked backward half)."""
    a = _layer()
    ref = np.asarray(jax_bilstm_fused(*_jax(a), jnp.dtype(cd), 16))
    got = K.bilstm_fused(*_torch(a), compute_dtype=getattr(torch, cd))
    np.testing.assert_allclose(got.numpy(), ref, **TOL[cd])
    assert np.all(got.numpy()[2, 1:] == 0.0)  # zero past lens


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_round_xg_matches_jax_scan_path(cd):
    """lstm_impl: scan semantics: the projection is stored in the compute
    dtype before the loop (models/encoder.py of the JAX package)."""
    a = _layer(1)
    x, lens, w_x, b_x, w_hf, w_hb = _jax(a)
    cdt = jnp.dtype(cd)
    xg = (jnp.dot(x.astype(cdt), w_x.astype(cdt),
                  preferred_element_type=jnp.float32) + b_x).astype(cdt)
    xg_f, xg_b = jnp.split(xg, 2, axis=-1)
    ref = np.asarray(jax_bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb, cdt))
    got = K.bilstm_fused(*_torch(a), compute_dtype=getattr(torch, cd),
                         round_xg=True)
    np.testing.assert_allclose(got.numpy(), ref, **TOL[cd])


def test_pallas_and_scan_semantics_agree_in_f32():
    a = _layer(2)
    fused = K.bilstm_fused(*_torch(a))
    scan = K.bilstm_fused(*_torch(a), round_xg=True)
    np.testing.assert_array_equal(fused.numpy(), scan.numpy())


def test_cpu_tensors_take_the_plain_version():
    calls, launches = K.bilstm_fused_plain.calls, K.bilstm_fused_kernel.launches
    K.bilstm_fused(*_torch(_layer()))
    assert K.bilstm_fused_plain.calls == calls + 1
    assert K.bilstm_fused_kernel.launches == launches


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    args = _torch(_layer())
    with pytest.raises(ValueError, match="CUDA"):
        K.bilstm_fused_kernel(*args)
    meta = tuple(t.to("meta") for t in args)
    with pytest.raises(ValueError, match="no implementation"):
        K.bilstm_fused(*meta)


def test_interleave_gates_layout():
    w = torch.arange(H * 4 * H, dtype=torch.float32).reshape(H, 4 * H)
    il = K._interleave_gates(w)
    for u in (0, 3, H - 1):
        for g in range(4):
            assert torch.equal(il[:, 4 * u + g], w[:, g * H + u])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_cell_step_matches_jax(cd):
    rng = np.random.RandomState(3)
    h, c = rng.randn(2, B, H).astype(np.float32)
    xg = rng.randn(B, 4 * H).astype(np.float32)
    w = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    ref = jax_cell_step(*(jnp.asarray(v) for v in (h, c, xg, w)),
                        compute_dtype=jnp.dtype(cd))
    got = lstm_cell_step(*(torch.from_numpy(v) for v in (h, c, xg, w)),
                         compute_dtype=getattr(torch, cd))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL["float32"])


def test_bilstm_scan_matches_jax():
    rng = np.random.RandomState(4)
    xg_f, xg_b = (rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
                  for _ in range(2))
    w_hf, w_hb = ((rng.randn(H, 4 * H) * 0.2).astype(np.float32)
                  for _ in range(2))
    args = (xg_f, xg_b, LENS, w_hf, w_hb)
    ref = jax_bilstm_scan(*(jnp.asarray(v) for v in args))
    got = bilstm_scan(*(torch.from_numpy(v) for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **TOL["float32"])


def test_jax_reference_runs_on_cpu():
    # The references above come from the kernel's interpret mode.
    assert jax.default_backend() == "cpu"
