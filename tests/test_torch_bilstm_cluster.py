"""PyTorch port, K1-bwd's cluster recurrence (``csrc/bilstm_bwd.cu::
bwd_cluster_kernel``) on the CPU: what of it can run without the card.

- the wrapper's layout of the 16 per-CTA slices of W_h
  (``ops/bilstm.py::_cluster_slices``), as the kernel's header states it;
- a torch emulation of the kernel's per-step decomposition of
  dh_rec = dg . W_h^T, in its own order: 16 owners' partial products over
  their own dg columns (depth 4U, padded units and rows included), then
  the reduce-scatter that sums each owner's 16 slots in slot order;
- a whole backward sweep built on that emulation, held against
  ``bilstm_fused_bwd_plain`` and against ``jax.vjp`` of the JAX package's
  ``bilstm_fused`` (its backward Pallas kernel in interpret mode), fed as
  ``tests/test_torch_bilstm_grad.py`` feeds it, at that file's
  tolerances (f32 rtol 1e-4 / atol 1e-5);
- the wrappers refusing CPU tensors.

The kernel itself runs only on the card (``tests/test_torch_cuda_bilstm.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

CTAS = K.CLUSTER_CTAS
NAMES = ("dx", "dw_x", "db", "dw_hf", "dw_hb")


@pytest.mark.parametrize("H", [8, 40, 130, 256, 320])
def test_cluster_slices_hold_every_weight_once_where_the_header_says(H):
    U = K._cluster_units(H)
    assert U % 4 == 0 and CTAS * U >= H and CTAS * (U - 4) < H
    w = torch.arange(1, H * 4 * H + 1, dtype=torch.float64).reshape(H, 4 * H)
    s = K._cluster_slices(w)
    assert s.shape == (CTAS, 4 * U, CTAS * U) and s.is_contiguous()
    # [j][u'] = W_h[u'][g*H + r*U + lu] with j = 4*lu + g, 0 past H
    r, j, u = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(CTAS), torch.arange(4 * U), torch.arange(CTAS * U),
        indexing="ij"))
    lu, g = j // 4, j % 4
    unit = r * U + lu
    live = (unit < H) & (u < H)
    want = torch.zeros(len(r), dtype=w.dtype)
    want[live] = w[u[live], g[live] * H + unit[live]]
    assert torch.equal(s.reshape(-1), want)
    # every element of W_h exactly once
    vals = s[s != 0]
    assert vals.numel() == H * 4 * H
    assert torch.equal(torch.sort(vals).values, w.reshape(-1))


def cluster_dh_rec(dg, slices, H, R):
    """dh_rec [rows, H] of one direction and step from dg [rows, 4H]
    (gate-major columns), the way bwd_cluster_kernel forms it with R rows
    a cluster (16, 32 or 48, as the launch chooses from what the card
    holds): rows in groups of R, each padded to R rows and 16U units; CTA r
    accumulates P_r = sum_j dg[:, col_r(j)] * slices[r][j] over its 4U
    columns in j order; owner c then sums slot r = P_r[:, c*U:(c+1)*U] over
    r = 0..15 in that order."""
    rows = dg.shape[0]
    U = K._cluster_units(H)
    Hp = CTAS * U
    out = []
    for b0 in range(0, rows, R):
        part = dg[b0:b0 + R]
        pad = dg.new_zeros(R, 4, Hp)
        pad[:part.shape[0], :, :H] = part.reshape(-1, 4, H)
        # CTA r's columns: [r, row, j] with j = 4*lu + g
        cols = pad.reshape(R, 4, CTAS, U).permute(2, 0, 3, 1).reshape(
            CTAS, R, 4 * U)
        partial = dg.new_zeros(CTAS, R, Hp)
        for j in range(4 * U):
            partial += cols[:, :, j, None] * slices[:, None, j, :]
        slots = partial.reshape(CTAS, R, CTAS, U)  # [sender, row, owner, lu]
        dh = dg.new_zeros(R, CTAS, U)
        for r in range(CTAS):
            dh = dh + slots[r]
        out.append(dh.reshape(R, Hp)[:part.shape[0], :H])
    return torch.cat(out)


@pytest.mark.parametrize("rows,H,R", [(1, 8, 16), (5, 40, 16), (50, 24, 32),
                                      (17, 130, 16), (96, 20, 48)])
def test_cluster_decomposition_equals_the_product(rows, H, R):
    rng = np.random.RandomState(rows + H)
    dg = torch.from_numpy(rng.randn(rows, 4 * H).astype(np.float32))
    w_h = torch.from_numpy((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    got = cluster_dh_rec(dg, K._cluster_slices(w_h), H, R)
    ref = dg @ w_h.T
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6


def _activations(xg, lens, w_hf, w_hb, y):
    """The gate activations K1-fwd's training form saves: sig(i),
    sig(f+1), tanh(g), sig(o) of both directions [B,T,8H], 0 past lens."""
    B, T, _ = xg.shape
    H = w_hf.shape[0]
    valid = (torch.arange(T)[None, :] < lens[:, None])[..., None].to(xg.dtype)
    zero = xg.new_zeros(B, 1, H)
    acts = []
    for d, w_h in enumerate((w_hf, w_hb)):
        hs = y[..., d * H:(d + 1) * H]
        h_prev = (torch.cat([zero, hs[:, :-1]], 1) if d == 0
                  else torch.cat([hs[:, 1:], zero], 1))
        gi, gf, gg, go = (xg[..., 4 * d * H:4 * (d + 1) * H]
                          + h_prev @ w_h).chunk(4, -1)
        acts.append(torch.cat([torch.sigmoid(gi), torch.sigmoid(gf + 1.0),
                               torch.tanh(gg), torch.sigmoid(go)], -1) * valid)
    return torch.cat(acts, -1)


def cluster_sweep(x, lens, w_x, b_x, w_hf, w_hb, dy):
    """K1-bwd in f32 as the card computes it with the cluster recurrence:
    the kernel's per-cell formulas over the saved activations, dh_rec from
    ``cluster_dh_rec``, then the products. Returns (dg, dx, dw_x, db,
    dw_hf, dw_hb)."""
    B, T, D = x.shape
    H = w_hf.shape[0]
    y, c = K.bilstm_fused_plain(x, lens, w_x, b_x, w_hf, w_hb, with_cell=True)
    xg = torch.cat(K._project(x, lens, w_x, b_x, torch.float32, False), -1)
    acts = _activations(xg, lens, w_hf, w_hb, y)
    dg = torch.zeros(B, T, 8 * H)
    dwh = []
    for d, w_h in enumerate((w_hf, w_hb)):
        slices = K._cluster_slices(w_h)
        cs = c[..., d * H:(d + 1) * H]
        dh_rec = torch.zeros(B, H)
        dcc = torch.zeros(B, H)
        for s in range(T):
            t = s if d else T - 1 - s
            tp = t + 1 if d else t - 1
            live = (t < lens)[:, None]
            si, sf, tg, so = acts[:, t, 4 * d * H:4 * (d + 1) * H].chunk(4, -1)
            th = torch.tanh(cs[:, t])
            cp = cs[:, tp] if 0 <= tp < T else torch.zeros(B, H)
            dh = dy[:, t, d * H:(d + 1) * H] + dh_rec
            dc = dh * so * (1 - th * th) + dcc
            g = torch.cat([dc * tg * si * (1 - si), dc * cp * sf * (1 - sf),
                           dc * si * (1 - tg * tg),
                           dh * th * so * (1 - so)], -1) * live
            dcc = dc * sf * live
            dg[:, t, 4 * d * H:4 * (d + 1) * H] = g
            dh_rec = cluster_dh_rec(g, slices, H, 16)
        hs = y[..., d * H:(d + 1) * H]
        zero = torch.zeros(B, 1, H)
        h_prev = (torch.cat([zero, hs[:, :-1]], 1) if d == 0
                  else torch.cat([hs[:, 1:], zero], 1))
        dwh.append(h_prev.reshape(-1, H).T @ dg[..., 4 * d * H:4 * (d + 1) * H]
                   .reshape(-1, 4 * H))
    dx = dg @ w_x.T
    dw_x = x.reshape(-1, D).T @ dg.reshape(-1, 8 * H)
    return dg, dx, dw_x, dg.sum((0, 1)), dwh[0], dwh[1]


def _layer(B, T, D, H, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    lens[-1] = 1
    a = {"x": rng.randn(B, T, D).astype(np.float32), "lens": lens,
         "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
         "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
         "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
         "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)}
    return a, rng.randn(B, T, 2 * H).astype(np.float32)


@pytest.mark.parametrize("B,T,D,H", [(4, 12, 5, 6), (5, 40, 7, 40),
                                     (2, 23, 3, 17)])
def test_cluster_sweep_matches_plain_and_jax_vjp(B, T, D, H):
    a, dy = _layer(B, T, D, H, seed=B + T + H)
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    got = cluster_sweep(*ins, torch.from_numpy(dy))
    # against the plain backward, and its dg
    y, c = K.bilstm_fused_plain(*ins, with_cell=True)
    ref = K.bilstm_fused_bwd_plain(*ins, y, c, torch.from_numpy(dy))
    xg = torch.cat(K._project(ins[0], ins[1], ins[2], ins[3], torch.float32,
                              False), -1)
    dg_ref, _, _ = K._bwd_sweep(xg, ins[1], ins[4], ins[5], y, c,
                                torch.from_numpy(dy), torch.float32)
    np.testing.assert_allclose(got[0].numpy(), dg_ref.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg="dg")
    for name, g, r in zip(NAMES, got[1:], ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # against jax.vjp of the JAX package's bilstm_fused
    x, lens, w_x, b_x, w_hf, w_hb = (jnp.asarray(v) for v in a.values())
    _, vjp = jax.vjp(
        lambda x, w_x, b_x, w_hf, w_hb: jax_bilstm_fused(
            x, lens, w_x, b_x, w_hf, w_hb, jnp.dtype("float32"), 8),
        x, w_x, b_x, w_hf, w_hb)
    for name, g, r in zip(NAMES, got[1:], vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("which", ["fused", "recur", "v1"])
def test_backward_wrappers_refuse_cpu_tensors(which):
    a, dy = _layer(3, 5, 4, 8, seed=0)
    x, lens, w_x, b_x, w_hf, w_hb = (torch.from_numpy(np.ascontiguousarray(v))
                                     for v in a.values())
    y = torch.zeros(3, 5, 16)
    acts = torch.zeros(3, 5, 64)
    dyt = torch.from_numpy(dy)
    calls = {f: f.launches for f in (K.bilstm_fused_bwd_kernel,
                                     K.bilstm_fused_bwd_recur_kernel,
                                     K.bilstm_pallas_bwd_kernel)}
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fused":
            K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, y, acts, dyt)
        elif which == "recur":
            K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, y, acts, dyt)
        else:
            K.bilstm_pallas_bwd_kernel(lens, w_hf, w_hb, y, y, acts, dyt)
    assert all(f.launches == n for f, n in calls.items())
