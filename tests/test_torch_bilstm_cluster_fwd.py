"""PyTorch port, K1-fwd's cluster recurrence (``csrc/bilstm_fwd.cu::
fwd_cluster_kernel``) on the CPU: what of it can run without the card.

- the wrapper's layout of the 16 per-CTA slices of W_h
  (``ops/bilstm.py::_cluster_fwd_slices``), as the kernel's header states
  it;
- a torch emulation of one step in the kernel's own decomposition: each
  of the 16 owners multiplies its copy of the padded h by its slice, the
  four k-blocks of a tile's lanes summed as (s0 + s2) + (s1 + s3), updates
  the cells of its units, and all-gathers its h' into the 16 copies of h;
  held against one step of ``bilstm_fused_plain``'s loop;
- whole sweeps built on that step, in the serving and the training form,
  rows of different lengths in one group, held against
  ``bilstm_fused_plain`` and against the JAX package's ``bilstm_fused``
  (its Pallas kernel in interpret mode), fed as
  ``tests/test_torch_bilstm.py`` feeds it, at that file's tolerances;
- the forward wrappers refusing CPU tensors, and the recurrence kernel
  chosen by H alone.

The kernel itself runs only on the card (``tests/test_torch_cuda_bilstm.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.models.lstm import lstm_cell_step
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

CTAS = K.CLUSTER_CTAS
KS = 4  # lanes a tile's depth is split over
# tests/test_torch_bilstm.py's tolerances against the JAX package
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=0.0, atol=1e-2)}


@pytest.mark.parametrize("H", [8, 40, 130, 256, 320])
def test_cluster_fwd_slices_hold_every_weight_once_where_the_header_says(H):
    U = K._cluster_units(H)
    Hp = CTAS * U
    w = torch.arange(1, H * 4 * H + 1, dtype=torch.float64).reshape(H, 4 * H)
    s = K._cluster_fwd_slices(w)
    assert s.shape == (CTAS, Hp, 4 * U) and s.is_contiguous()
    # [r][k][j] = W_h[k][g*H + r*U + lu] with j = 4*lu + g, 0 past H
    r, k, j = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(CTAS), torch.arange(Hp), torch.arange(4 * U),
        indexing="ij"))
    lu, g = j // 4, j % 4
    unit = r * U + lu
    live = (unit < H) & (k < H)
    want = torch.zeros(len(r), dtype=w.dtype)
    want[live] = w[k[live], g[live] * H + unit[live]]
    assert torch.equal(s.reshape(-1), want)
    # every element of W_h exactly once
    vals = s[s != 0]
    assert vals.numel() == H * 4 * H
    assert torch.equal(torch.sort(vals).values, w.reshape(-1))
    # slice r is columns [4rU, 4rU + 4U) of the gate-interleaved W_h, padded
    il = torch.zeros(Hp, 4 * Hp, dtype=w.dtype)
    il[:H, :4 * H] = K._interleave_gates(w)
    for rank in (0, CTAS - 1):
        cols = il[:, 4 * rank * U:4 * (rank + 1) * U]
        assert torch.equal(s[rank], cols)


def _round(v, cd):
    return v.to(cd).to(torch.float32)


def cluster_step(hbufs, c, xg_t, live, slices, H, cd):
    """One step of ``fwd_cluster_kernel`` for one direction and one group
    of R rows, in the kernel's decomposition. hbufs [16, R, 16U]: each
    CTA's copy of h, as the buffers hold it (rounded to ``cd``); c [R, 16U]
    (each owner's cells); xg_t [R, 4H] gate-major projections of the step;
    live [R] (t < lens). Returns (the next 16 copies of h, c, y [R, H], c
    stream [R, H], activations [R, 4H] gate-major); the streams 0 where not
    live."""
    R = hbufs.shape[1]
    U = K._cluster_units(H)
    Hp = CTAS * U
    KB = Hp // KS
    w = _round(slices, cd)
    c = c.clone()
    owned = []
    y = torch.zeros(R, H)
    cs = torch.zeros(R, H)
    acts = torch.zeros(R, 4 * H)
    for r in range(CTAS):
        hb = hbufs[r]
        # the four lanes' partial sums over their k-blocks, then the
        # reduce-scatter's order
        p = [hb[:, s * KB:(s + 1) * KB] @ w[r, s * KB:(s + 1) * KB]
             for s in range(KS)]
        gates = ((p[0] + p[2]) + (p[1] + p[3])).reshape(R, U, 4)
        units = r * U + torch.arange(U)
        ok = units < H
        xv = torch.zeros(R, U, 4)
        for q in range(4):
            xv[:, ok, q] = xg_t[:, q * H + units[ok]]
        pre = xv + gates
        si, sf = torch.sigmoid(pre[..., 0]), torch.sigmoid(pre[..., 1] + 1.0)
        tg, so = torch.tanh(pre[..., 2]), torch.sigmoid(pre[..., 3])
        cn = sf * c[:, units] + si * tg
        hn = so * torch.tanh(cn)
        m = live[:, None] & ok[None, :]
        c[:, units] = torch.where(m, cn, c[:, units])
        owned.append(torch.where(m, _round(hn, cd), hb[:, units]))
        u = units[ok]
        mo = m[:, ok]
        y[:, u] = torch.where(mo, hn[:, ok], 0.0)
        cs[:, u] = torch.where(mo, cn[:, ok], 0.0)
        for q, a in enumerate((si, sf, tg, so)):
            acts[:, q * H + u] = torch.where(mo, a[:, ok], 0.0)
    # the all-gather: every CTA's next buffer receives every owner's h'
    nxt = torch.cat(owned, 1)[None].repeat(CTAS, 1, 1)
    return nxt, c, y, cs, acts


@pytest.mark.parametrize("rows,H,R", [(1, 8, 16), (5, 40, 16), (17, 24, 32),
                                      (3, 130, 16), (40, 20, 48)])
def test_cluster_step_equals_one_step_of_the_plain_loop(rows, H, R):
    rng = np.random.RandomState(rows + H)
    U = K._cluster_units(H)
    Hp = CTAS * U
    h = torch.from_numpy(rng.randn(rows, H).astype(np.float32) * 0.5)
    c = torch.from_numpy(rng.randn(rows, H).astype(np.float32))
    xg = torch.from_numpy(rng.randn(rows, 4 * H).astype(np.float32))
    w_h = torch.from_numpy((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    live = torch.from_numpy(rng.rand(rows) < 0.7)
    live[0] = True
    hp = torch.zeros(R, Hp)
    hp[:rows, :H] = h
    cp = torch.zeros(R, Hp)
    cp[:rows, :H] = c
    xp = torch.zeros(R, 4 * H)
    xp[:rows] = xg
    lp = torch.zeros(R, dtype=torch.bool)
    lp[:rows] = live
    nxt, c2, y, cs, acts = cluster_step(hp[None].repeat(CTAS, 1, 1), cp, xp, lp,
                                        K._cluster_fwd_slices(w_h), H,
                                        torch.float32)
    h_ref, c_ref = lstm_cell_step(h, c, xg, w_h)
    lv = live[:, None]
    want_h = torch.where(lv, h_ref, h)
    want_c = torch.where(lv, c_ref, c)
    for copy in nxt:  # 16 equal copies; padded units and rows stay 0
        assert float((copy[:rows, :H] - want_h).abs().max()) <= 1e-6
        assert not copy[:, H:].any() and not copy[rows:].any()
    assert float((c2[:rows, :H] - want_c).abs().max()) <= 1e-6
    assert float((y[:rows] - torch.where(lv, h_ref, 0.0)).abs().max()) <= 1e-6
    assert float((cs[:rows] - torch.where(lv, c_ref, 0.0)).abs().max()) <= 1e-6
    gi, gf, gg, go = (xg + h @ w_h).chunk(4, -1)
    a_ref = torch.cat([torch.sigmoid(gi), torch.sigmoid(gf + 1.0),
                       torch.tanh(gg), torch.sigmoid(go)], -1)
    assert float((acts[:rows] - torch.where(lv, a_ref, 0.0)).abs().max()) <= 1e-6


def cluster_sweep(x, lens, w_x, b_x, w_hf, w_hb, cd, R=16):
    """K1-fwd as the card computes it with the cluster recurrence: the
    projection, then per direction and group of R rows the kernel's steps
    (``cluster_step``), the backward direction sweeping t = T-1 .. 0.
    Returns (y, c stream [B,T,2H], activations [B,T,8H])."""
    B, T, _ = x.shape
    H = w_hf.shape[0]
    U = K._cluster_units(H)
    Hp = CTAS * U
    xgs = K._project(x, lens, w_x, b_x, cd, False)
    y = torch.zeros(B, T, 2 * H)
    cs = torch.zeros(B, T, 2 * H)
    acts = torch.zeros(B, T, 8 * H)
    for d, w_h in enumerate((w_hf, w_hb)):
        slices = K._cluster_fwd_slices(w_h)
        for b0 in range(0, B, R):
            n = min(R, B - b0)
            hbufs = torch.zeros(CTAS, R, Hp)
            c = torch.zeros(R, Hp)
            for s in range(T):
                t = T - 1 - s if d else s
                xg_t = torch.zeros(R, 4 * H)
                xg_t[:n] = xgs[d][b0:b0 + n, t]
                live = torch.zeros(R, dtype=torch.bool)
                live[:n] = t < lens[b0:b0 + n]
                hbufs, c, yt, ct, at = cluster_step(hbufs, c, xg_t, live,
                                                    slices, H, cd)
                y[b0:b0 + n, t, d * H:(d + 1) * H] = yt[:n]
                cs[b0:b0 + n, t, d * H:(d + 1) * H] = ct[:n]
                acts[b0:b0 + n, t, 4 * d * H:4 * (d + 1) * H] = at[:n]
    return y, cs, acts


def _layer(B, T, D, H, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    lens[-1] = 1
    return {"x": rng.randn(B, T, D).astype(np.float32), "lens": lens,
            "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
            "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
            "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
            "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)}


def _activations(xg, lens, w_hf, w_hb, y):
    """The gate activations of the training form, from the plain h stream:
    sig(i), sig(f+1), tanh(g), sig(o) of both directions, 0 past lens."""
    B, T, _ = xg.shape
    H = w_hf.shape[0]
    valid = (torch.arange(T)[None, :] < lens[:, None])[..., None].float()
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


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [(4, 12, 5, 6), (5, 40, 7, 40),
                                     (2, 23, 3, 17)])
def test_cluster_sweep_matches_plain_and_jax(B, T, D, H, cd):
    a = _layer(B, T, D, H, seed=B + T + H)
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    y, c, acts = cluster_sweep(*ins, cd)
    # the serving form against the plain version and the JAX package
    y_ref, c_ref = K.bilstm_fused_plain(*ins, compute_dtype=cd, with_cell=True)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL[cd])
    ref = np.asarray(jax_bilstm_fused(*(jnp.asarray(v) for v in a.values()),
                                      jnp.dtype(str(cd).split(".")[1]), 16))
    np.testing.assert_allclose(y.numpy(), ref, **TOL[cd])
    # rows of different lengths in one group: 0 past lens
    lens = ins[1]
    past = torch.arange(T)[None, :] >= lens[:, None]
    assert not y[past].any() and not c[past].any() and not acts[past].any()
    # the training form's streams
    np.testing.assert_allclose(c.numpy(), c_ref.numpy(), **TOL[cd])
    if cd == torch.float32:
        xg = torch.cat(K._project(ins[0], lens, ins[2], ins[3], cd, False), -1)
        np.testing.assert_allclose(
            acts.numpy(), _activations(xg, lens, ins[4], ins[5], y_ref).numpy(),
            **TOL[cd])


@pytest.mark.parametrize("which", ["fused", "fused training", "recur", "v1"])
def test_forward_wrappers_refuse_cpu_tensors(which):
    a = _layer(3, 5, 4, 8, seed=0)
    x, lens, w_x, b_x, w_hf, w_hb = (torch.from_numpy(np.ascontiguousarray(v))
                                     for v in a.values())
    fns = (K.bilstm_fused_kernel, K.bilstm_fused_fwd_recur_kernel,
           K.bilstm_pallas_kernel)
    calls = {f: (f.launches, f.cluster_launches) for f in fns}
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fused":
            K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb)
        elif which == "fused training":
            K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb, with_cell=True)
        elif which == "recur":
            K.bilstm_fused_fwd_recur_kernel(torch.zeros(3, 5, 64), lens, w_hf,
                                            w_hb)
        else:
            K.bilstm_pallas_kernel(torch.zeros(3, 5, 32), torch.zeros(3, 5, 32),
                                   lens, w_hf, w_hb)
    assert all((f.launches, f.cluster_launches) == n for f, n in calls.items())


@pytest.mark.parametrize("H", [1, 8, 256, 320, 321, 400, 1024])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_forward_route_is_chosen_by_hidden_size_alone(H, cd):
    w = torch.randn(H, 4 * H, generator=torch.Generator().manual_seed(H))
    wf, wb, cluster = K._fwd_weights(w, w, cd)
    assert cluster == (H <= 320) and wf.dtype == wb.dtype == cd
    if cluster:
        U = K._cluster_units(H)
        assert wf.shape == (CTAS, CTAS * U, 4 * U)
        assert torch.equal(wf, K._cluster_fwd_slices(w).to(cd))
    else:
        assert torch.equal(wf, K._interleave_gates(w).to(cd))
