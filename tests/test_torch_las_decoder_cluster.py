"""PyTorch port, K4-bwd's cluster kernel (``csrc/las_decoder.cu::
bwd_cluster_kernel``) on the CPU: what of it can run without the card.

- the wrapper's per-CTA weight slices (``ops/las_decoder.py::
  _cluster_slices``) hold every weight once, where the kernel's
  header says;
- a torch emulation of one backward step in the kernel's decomposition:
  8 CTAs each owning one batch row and a slice of the H units, the D
  context columns and the E embedding columns; the three products split
  by those columns and by depth splits summed in order; the row's own
  phases (the attention gradient, the softmax backward, dot's dqb, the
  energy phase over chunks of 64 frames, loc's feature and carry as the
  convolution and correlation with the filter); and the three exchanges
  (dctx_total to the row's CTA, dqb and dgates to every CTA) as copies
  into each CTA's receive slots. Held against one step of
  ``las_decoder_bwd_plain``'s sweep in dot, add and loc;
- whole sweeps built on that step with ragged rows (B not a multiple of
  8, B < 8, a row with no frames, widths that leave slices padded), held
  against ``las_decoder_bwd_plain`` and, in f32, against ``jax.vjp`` of
  the JAX package's ``las_decoder_fused`` (its Pallas kernels in interpret
  mode, fed as ``tests/test_torch_decoder.py`` feeds it), at that file's
  gradient tolerance;
- the kernel chosen by shape alone (``bwd_route``), and CPU tensors
  taking the plain version.

The kernel itself runs only on the card (``tests/test_torch_cuda_decoder.py``).

Tolerances. f32: only the order of the sums differs: 2e-5 of each
output's largest magnitude (``tests/test_torch_decoder.py``'s gradient
tolerance). bf16: both sides round the same operands to bf16 and sum in
f32 in another order: 1e-4 of the largest magnitude (the same file's
bf16 tolerance), which a sum on the other side of a rounding boundary,
one operand changed by one bf16 ulp (2^-8), would exceed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_decoder import (
    build_loc_band_cmajor as jax_band, las_decoder_fused)
from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

torch.set_num_threads(1)

R = K.CLUSTER_ROWS
TILE = 64  # frames of an energy chunk at one row a CTA
TOL_F32 = 2e-5
TOL_BF16 = 1e-4


def _r(x, cd):
    return x.to(cd).float()


@pytest.mark.parametrize("segments,K_", [
    (((0, 320), (320, 640)), 32),        # the head at the flagship's widths
    (((0, 10),), 8),                      # the query, H not a multiple of 4
    (((0, 6), (6, 18), (24, 10)), 40),    # the gates, every part padded
])
def test_cluster_bwd_slices_hold_every_weight_once_where_the_header_says(
        segments, K_):
    N = sum(x for _, x in segments)
    m = torch.arange(1, N * K_ + 1, dtype=torch.float64).reshape(N, K_)
    s = K._cluster_slices(m, segments)
    widths = [K._cluster_units(x) for _, x in segments]
    Nr = sum(widths)
    assert s.shape == (R, K_, Nr) and s.is_contiguous()
    # [r][k][n] = m[row of CTA r's local column n, k]; 0 past a part
    for r in range(R):
        local = 0
        for (first, X), U in zip(segments, widths):
            for j in range(U):
                col = r * U + j
                got = s[r, :, local + j]
                want = m[first + col] if col < X else torch.zeros(K_, dtype=m.dtype)
                assert torch.equal(got, want), (r, first, j)
            local += U
    vals = s[s != 0]
    assert vals.numel() == N * K_
    assert torch.equal(torch.sort(vals).values, m.reshape(-1))


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def _case(B, L, T, D, A, E, H, V, kind, seed, C=3, W=5):
    """(tokens, coins, enc, enc_proj, enc_len, weights, filter [W,1,C] or
    None) from numpy: the last row has no frames, the first all T."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    enc_len = rng.randint(1, T + 1, size=B).astype(np.int32)
    enc_len[0], enc_len[-1] = T, 0
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    enc = torch.tanh(f(B, T, D))
    z = torch.zeros
    energy = kind != "dot"
    w = K.Weights(f(V, E) / np.sqrt(E), f(E + D, 4 * H) / np.sqrt(E + D),
                  f(4 * H) * 0.1, f(H, 4 * H) / np.sqrt(H), f(H, A) / np.sqrt(H),
                  f(A) * 0.1 if energy else z(A),
                  f(A, 1) / np.sqrt(A) if energy else z(A, 1),
                  f(C, A) / np.sqrt(C) if kind == "loc" else z(1, A),
                  f(H + D, V) / np.sqrt(H + D), f(V) * 0.1)
    enc_proj = enc @ (f(D, A) / np.sqrt(D))
    filt = f(W, 1, C) / np.sqrt(W) if kind == "loc" else None
    return (torch.from_numpy(tokens), torch.zeros(B, L, dtype=torch.bool), enc,
            enc_proj, torch.from_numpy(enc_len), w, filt)


def _forward(case, kind, cd):
    """The plain forward's residuals and what K4-fwd saves beside them:
    the gate activations [B,L,4H] and the query with its bias [B,L,A]."""
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    band = None if filt is None else K.build_loc_band_cmajor(filt, enc.shape[1])
    logits, resid = K.las_decoder_fwd_plain(tokens, coins, enc, enc_proj,
                                            enc_len, w, cd, kind, band)
    h, c, att, ctx, tok = resid
    H = w.w_h.shape[0]
    x = torch.cat([_r(w.embed[tok.long()], cd), K._shift_right(ctx)], -1)
    g = (_r(x, cd) @ _r(w.w_x, cd) + w.b_x
         + _r(K._shift_right(h), cd) @ _r(w.w_h, cd))
    gi, gf, gg, go = torch.split(g, H, -1)
    acts = torch.cat([torch.sigmoid(gi), torch.sigmoid(gf + 1.0),
                      torch.tanh(gg), torch.sigmoid(go)], -1)
    q = _r(h, cd) @ _r(w.att_q, cd) + w.att_b
    return logits, resid, acts, q, band


def _product(v, slices, S, cd):
    """cl_product for every CTA: v [R, K] (rounded) times each slice [K,
    N] -> [R CTAs][R rows, N], the S depth splits summed in order."""
    K_ = v.shape[1]
    kc = -(-K_ // S)
    out = []
    for sl in slices:
        w = _r(sl, cd)
        acc = torch.zeros(v.shape[0], w.shape[1])
        for s in range(S):
            acc = acc + v[:, s * kc:(s + 1) * kc] @ w[s * kc:(s + 1) * kc]
        out.append(acc)
    return out


class Cluster:
    """The state of one cluster of bwd_cluster_kernel across steps: each
    CTA's carries of its columns and each row's own carries, and the
    streams it writes."""

    def __init__(self, b0, args, kind, cd):
        (self.dl, self.resid, self.acts, self.q, self.enc, self.encp,
         self.enc_len, self.w, self.filt) = args
        self.b0, self.kind, self.cd = b0, kind, cd
        B, L, V = self.dl.shape
        _, T, D = self.enc.shape
        H, E, A = self.w.w_h.shape[0], self.w.embed.shape[1], self.w.att_q.shape[1]
        self.dims = B, L, T, D, A, E, H, V
        self.HU, self.DU, self.EU = (K._cluster_units(x) for x in (H, D, E))
        wcat = torch.cat([self.w.w_x, self.w.w_h], 0)
        self.sl_head = K._cluster_slices(self.w.w_out, ((0, H), (H, D)))
        self.sl_query = K._cluster_slices(self.w.att_q, ((0, H),))
        self.sl_gates = K._cluster_slices(wcat, ((0, E), (E, D), (E + D, H)))
        z = torch.zeros
        self.dh = z(R, R, self.HU)     # [CTA][row][its units]
        self.dc = z(R, R, self.HU)
        self.dctxc = z(R, R, self.DU)
        self.datt_c = z(R, T)          # [row][frame]: loc's carry
        self.dv = z(R, A)
        self.dlocp = z(R, self.filt.shape[2] if self.filt is not None else 1, A)

    def _rows(self):
        B = self.dims[0]
        return [self.b0 + r for r in range(R)], [self.b0 + r < B for r in range(R)]

    def step(self, i, out):
        B, L, T, D, A, E, H, V = self.dims
        HU, DU, EU, cd = self.HU, self.DU, self.EU, self.cd
        rows, live = self._rows()
        z = torch.zeros
        # (a) the head's input
        vh = z(R, V)
        for r, b in enumerate(rows):
            if live[r]:
                vh[r] = _r(self.dl[b, i], cd)
        # (b) the head, then exchange 1 into each row's slot1
        NH = HU + DU
        head = _product(vh, self.sl_head, K._cluster_splits(NH // 4, V), cd)
        dh_tot = [self.dh[k] + head[k][:, :HU] for k in range(R)]
        slot1 = z(R, D)
        for k in range(R):
            x = self.dctxc[k] + head[k][:, HU:]
            for dl in range(DU):
                d = k * DU + dl
                if d >= D:
                    continue
                for r, b in enumerate(rows):
                    if live[r]:
                        out["dctx"][b, i, d] = x[r, dl]
                slot1[:, d] = _r(x[:, dl], cd)
        # (c) each row's own phases; exchange 2 into every CTA's slot2
        slot2 = z(R, A)
        for r, b in enumerate(rows):
            slot2[r] = self._row(r, b, i, slot1[r], out) if live[r] else 0.0
        # (d) the query's gradient and the cells of each CTA's units;
        # exchange 3 into every CTA's slot3
        query = _product(slot2, self.sl_query, K._cluster_splits(HU // 4, A), cd)
        slot3 = z(R, 4 * H)
        for k in range(R):
            for ul in range(HU):
                u = k * HU + ul
                if u >= H:
                    continue
                for r, b in enumerate(rows):
                    if not live[r]:
                        continue
                    dht = dh_tot[k][r, ul] + query[k][r, ul]
                    si, sf, tg, so = (self.acts[b, i, j * H + u] for j in range(4))
                    cp = self.resid[1][b, i - 1, u] if i > 0 else torch.tensor(0.0)
                    tc = torch.tanh(self.resid[1][b, i, u])
                    dct = dht * so * (1 - tc * tc) + self.dc[k, r, ul]
                    g = [dct * tg * si * (1 - si), dct * cp * sf * (1 - sf),
                         dct * si * (1 - tg * tg), dht * tc * so * (1 - so)]
                    self.dc[k, r, ul] = dct * sf
                    for j in range(4):
                        out["dgates"][b, i, j * H + u] = g[j]
                        slot3[r, j * H + u] = _r(g[j], cd)
        # (e) dgates . [W_x; W_h]^T into each CTA's columns
        NX = EU + DU + HU
        gp = _product(slot3, self.sl_gates, K._cluster_splits(NX // 4, 4 * H), cd)
        for k in range(R):
            for el in range(EU):
                e = k * EU + el
                for r, b in enumerate(rows):
                    if e < E and live[r]:
                        out["demb"][b, i, e] = gp[k][r, el]
            self.dctxc[k] = gp[k][:, EU:EU + DU]
            self.dh[k] = gp[k][:, EU + DU:]

    def _row(self, r, b, i, dctx_r, out):
        """Row b's phases in its CTA: returns its dqb, rounded."""
        B, L, T, D, A, E, H, V = self.dims
        cd, n = self.cd, int(self.enc_len[b])
        datt = torch.zeros(T)
        datt[:n] = _r(self.enc[b, :n], cd) @ dctx_r
        if self.kind == "loc":
            datt[:n] = self.datt_c[r, :n] + datt[:n]
        al = self.resid[2][b, i]
        tot = (datt[:n] * al[:n]).sum()
        scale = K._scale(A) if self.kind == "dot" else 1.0
        ds = torch.zeros(T)
        ds[:n] = al[:n] * (datt[:n] - tot) * scale
        if self.kind == "dot":
            out["dsn"][b, i] = ds
            dq = ds[:n] @ _r(self.encp[b, :n], cd)
        else:
            dq = self._energies(r, b, i, ds, n, out)
        out["dqb"][b, i] = dq
        return _r(dq, cd)

    def _energies(self, r, b, i, ds, n, out):
        B, L, T, D, A, E, H, V = self.dims
        cd, loc, w = self.cd, self.kind == "loc", self.w
        v = w.att_v[:, 0]
        if loc:
            filt = _r(self.filt[:, 0, :], cd)  # [W, C]
            Wd, C = filt.shape
            pad = (Wd - 1) // 2
            attp = _r(self.resid[2][b, i - 1], cd) if i > 0 else torch.zeros(T)
            f = torch.zeros(C, T)  # the feature, as the convolution
            for t in range(n):
                for k in range(max(0, pad - t), min(Wd, n - t + pad)):
                    f[:, t] += attp[t + k - pad] * filt[k]
            f = _r(f, cd)
            locp = _r(w.loc_proj, cd)
            dfct = torch.zeros(C, T)
        dq = torch.zeros(A)
        for t0 in range(0, n, TILE):
            t1 = min(t0 + TILE, n)
            e = _r(self.encp[b, t0:t1], cd) + self.q[b, i]
            if loc:
                e = e + f[:, t0:t1].T @ locp
            th = torch.tanh(e)
            de = (1 - th * th) * ds[t0:t1, None] * v
            out["d_encp"][b, t0:t1] += de
            self.dv[r] += (th * ds[t0:t1, None]).sum(0)
            dq = dq + de.sum(0)
            if loc:
                de_r = _r(de, cd)
                dfct[:, t0:t1] = (de_r @ locp.T).T
                self.dlocp[r] += f[:, t0:t1] @ de_r
        if loc:
            out["dfct"][b, i] = dfct.reshape(-1)
            dfct = _r(dfct, cd)
            carry = torch.zeros(T)  # dfct . band^T, as the correlation
            for s in range(n):
                for t in range(max(0, s + pad - Wd + 1), min(n - 1, s + pad) + 1):
                    carry[s] += (dfct[:, t] * filt[s - t + pad]).sum()
            self.datt_c[r] = carry
        return dq


def _emulate(case, kind, cd):
    """K4-bwd's streams through the emulated cluster kernel, every
    cluster of ceil(B / 8) run step by step; then d_enc_proj for dot (as
    d_encp_kernel) and the fixed-order sums of the per-row partials."""
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    logits, resid, acts, q, band = _forward(case, kind, cd)
    B, L, V = logits.shape
    T, D = enc.shape[1], enc.shape[2]
    H, E, A = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1]
    dl = torch.from_numpy(np.random.RandomState(7).randn(B, L, V).astype(np.float32))
    out = {"dgates": torch.zeros(B, L, 4 * H), "dctx": torch.zeros(B, L, D),
           "dqb": torch.zeros(B, L, A), "demb": torch.zeros(B, L, E),
           "dsn": torch.zeros(B, L, T), "d_encp": torch.zeros(B, T, A)}
    C = filt.shape[2] if filt is not None else 0
    if kind == "loc":
        out["dfct"] = torch.zeros(B, L, C * T)
    args = (dl, resid, acts, q, enc, enc_proj, enc_len, w, filt)
    clusters = [Cluster(b0, args, kind, cd) for b0 in range(0, B, R)]
    for i in range(L - 1, -1, -1):
        for cl in clusters:
            cl.step(i, out)
    if kind == "dot":
        out["d_encp"] = torch.einsum("bit,bia->bta", out["dsn"], q)
    else:
        dv = torch.cat([cl.dv for cl in clusters])[:B]
        out["d_att_v"] = dv.sum(0)[:, None]
    if kind == "loc":
        out["d_loc_proj"] = torch.cat([cl.dlocp for cl in clusters])[:B].sum(0)
    return out, (dl, resid, band)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _names(kind):
    return (["dgates", "dctx", "dqb", "demb", "d_encp"]
            + ([] if kind == "dot" else ["d_att_v"])
            + (["d_loc_proj", "dfct"] if kind == "loc" else []))


# B, L, T, D, A, E, H, V: widths that leave every slice padded (H=10, D=18,
# E=6 over 8 CTAs), more frames than a chunk of 64
STEP_SHAPE = (9, 3, 70, 18, 8, 6, 10, 11)


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_one_step_matches_the_plain_sweep(kind, cd):
    """One step (the sweep's first, i = L-1) of two clusters, the second
    with one live row, against the same step of las_decoder_bwd_plain."""
    B, L = STEP_SHAPE[:2]
    case = _case(*STEP_SHAPE, kind, seed=1)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    _, resid, acts, q, band = _forward(case, kind, cd)
    dl = torch.from_numpy(np.random.RandomState(7).randn(B, L, w.embed.shape[0])
                          .astype(np.float32))
    dl[:, :L - 1] = 0.0  # only the last step's cotangent: its step alone
    ref = K.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len, w, cd,
                                  kind, band)
    out = {k: torch.zeros_like(v) for k, v in ref.items()
           if v is not None and v.dim() == 3}
    out["dsn"] = torch.zeros(B, L, enc.shape[1])
    args = (dl, resid, acts, q, enc, enc_proj, enc_len, w, filt)
    clusters = [Cluster(b0, args, kind, cd) for b0 in range(0, B, R)]
    for cl in clusters:
        cl.step(L - 1, out)
    tol = TOL_F32 if cd == torch.float32 else TOL_BF16
    for name in ("dgates", "dctx", "dqb", "demb") + (("dfct",) if kind == "loc" else ()):
        assert _rel(out[name][:, L - 1], ref[name][:, L - 1]) <= tol, name


SWEEPS = [
    # B not a multiple of 8 (two clusters, the second with 3 rows)
    (11, 6, 13, 18, 8, 6, 10, 11),
    # B < 8, more frames than a chunk
    (5, 4, 70, 16, 12, 8, 12, 9),
]


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWEEPS)
def test_sweep_matches_plain(kind, cd, shape):
    case = _case(*shape, kind, seed=2)
    got, (dl, resid, band) = _emulate(case, kind, cd)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    ref = K.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len, w, cd,
                                  kind, band)
    tol = TOL_F32 if cd == torch.float32 else TOL_BF16
    for name in _names(kind):
        assert _rel(got[name], ref[name]) <= tol, (name, _rel(got[name], ref[name]))
    # the row with no frames attends nowhere: its dqb is 0
    assert not got["dqb"][-1].any()


def _jax_grads(case, kind, dl):
    """Every gradient of jax.vjp of las_decoder_fused (f32, interpret
    mode) at the case's inputs, by the port's names."""
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    T = enc.shape[1]
    n = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    mask = (np.arange(T)[None] < enc_len.numpy()[:, None]).astype(np.float32)
    is_loc = kind == "loc"
    names = ["enc", "enc_proj", "embed", "w_x", "b_x", "w_h", "att_q",
             "w_out", "b_out"] + (["att_b", "att_v"] if kind != "dot" else []) \
        + (["loc_filter", "loc_proj"] if is_loc else [])
    prim = {"enc": n(enc), "enc_proj": n(enc_proj), "embed": n(w.embed),
            "w_x": n(w.w_x), "b_x": n(w.b_x), "w_h": n(w.w_h),
            "att_q": n(w.att_q), "att_b": n(w.att_b), "att_v": n(w.att_v),
            "loc_proj": n(w.loc_proj), "w_out": n(w.w_out), "b_out": n(w.b_out),
            "loc_filter": n(filt) if is_loc else jnp.zeros((1, 1))}

    def f(*d):
        p = dict(prim, **dict(zip(names, d)))
        band = jax_band(p["loc_filter"], T) if is_loc else jnp.zeros((1, 1))
        return las_decoder_fused(
            ("float32", 4, kind), jnp.asarray(tokens.numpy()),
            jnp.asarray(coins.numpy().astype(np.float32)), p["enc"],
            p["enc_proj"], jnp.asarray(mask), band, p["embed"], p["w_x"],
            p["b_x"], p["w_h"], p["att_q"], p["att_b"], p["att_v"],
            p["loc_proj"], p["w_out"], p["b_out"])

    _, vjp = jax.vjp(f, *(prim[k] for k in names))
    return dict(zip(names, (np.asarray(g) for g in vjp(jnp.asarray(dl.numpy())))))


@pytest.mark.parametrize("kind", K.ATT_KINDS)
def test_sweep_matches_jax_vjp(kind):
    """The emulated sweep's streams, turned into gradients as the port's
    backward turns the kernel's (weight_grads, the filter's through the
    band), against jax.vjp of the JAX package's fused decoder."""
    case = _case(*SWEEPS[0], kind, seed=3)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    got, (dl, resid, band) = _emulate(case, kind, torch.float32)
    g = K.weight_grads(got, resid, dl, w)
    mine = {"enc": g["enc"], "enc_proj": got["d_encp"], "embed": g["embed"],
            "w_x": g["w_x"], "b_x": g["b_x"], "w_h": g["w_h"],
            "att_q": g["att_q"], "w_out": g["w_out"], "b_out": g["b_out"]}
    if kind != "dot":
        mine.update(att_b=g["att_b"], att_v=got["d_att_v"])
    if kind == "loc":
        f = filt.clone().requires_grad_(True)
        (mine["loc_filter"],) = torch.autograd.grad(
            K.build_loc_band_cmajor(f, enc.shape[1]), f, g["band"])
        mine["loc_proj"] = got["d_loc_proj"]
    ref = _jax_grads(case, kind, dl)
    assert set(ref) == set(mine)
    for name, a in ref.items():
        b = mine[name].detach().numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=TOL_F32,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

FLAGSHIP = dict(D=640, A=320, E=256, H=320, V=32, C=10, W=100)


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [100, 320])
def test_flagship_shapes_take_the_cluster_kernel(kind, cd, T):
    """The 4.0 s bucket and bench.py's T' at the flagships' widths."""
    assert K.bwd_route(kind, cd, T, **FLAGSHIP) == "cluster"


def test_route_by_shape_alone():
    f32 = torch.float32
    # a vocabulary whose head input outgrows the cluster plan: bwd_kernel
    assert K.bwd_route("dot", f32, 19, 12, 8, 6, 8, 8000) == "rows"
    # loc at T' = 600: neither plan fits, as bwd_kernel's did not before
    assert K.bwd_route("loc", f32, 600, **FLAGSHIP) is None
    # every shape bwd_kernel took still has a kernel
    rng = np.random.RandomState(0)
    for _ in range(200):
        kind = K.ATT_KINDS[rng.randint(3)]
        cd = (torch.float32, torch.bfloat16)[rng.randint(2)]
        dims = dict(T=int(rng.randint(1, 700)), D=int(rng.randint(1, 2048)),
                    A=4 * int(rng.randint(1, 129)), E=int(rng.randint(1, 1024)),
                    H=int(rng.randint(1, 1025)), V=int(rng.randint(1, 9000)),
                    C=int(rng.randint(1, 17)), W=int(rng.randint(1, 200)))
        cols = 8 if cd == torch.bfloat16 else 4
        old_fits = 4 * K._rows_plan(kind, *dims.values(), cols) <= K._MAX_SMEM
        route = K.bwd_route(kind, cd, **dims)
        assert (route is not None) == (
            old_fits or 4 * K._cluster_plan(kind, *dims.values(), cols) <= K._MAX_SMEM)
        if old_fits:
            assert route is not None


def test_cpu_tensors_take_the_plain_version():
    case = _case(5, 3, 9, 16, 8, 8, 12, 9, "loc", seed=4)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    enc = enc.clone().requires_grad_(True)
    before = (K.las_decoder_bwd_kernel.launches,
              K.las_decoder_bwd_kernel.cluster_launches,
              K.las_decoder_bwd_plain.calls)
    logits = K.las_decoder(tokens, coins, enc, enc_proj, enc_len, w,
                           torch.float32, "loc", filt)
    logits.sum().backward()
    assert (K.las_decoder_bwd_kernel.launches,
            K.las_decoder_bwd_kernel.cluster_launches) == before[:2]
    assert K.las_decoder_bwd_plain.calls == before[2] + 1
    with pytest.raises(ValueError, match="CUDA"):
        _, resid, acts, q, _ = _forward(case, "loc", torch.float32)
        K.las_decoder_bwd_kernel(torch.zeros(logits.shape), resid, (acts, q),
                                 enc.detach(), enc_proj, enc_len, w,
                                 torch.float32, "loc", filt)


def test_k4_probe_variants_find_their_text_in_the_source():
    """Each build variant of tools/k4_probe.py (each direction's old
    design, its cycle counting and every cut) changes the text it names,
    as often as it says."""
    from gluon_e2e_asr_tpu_torch import _build
    from gluon_e2e_asr_tpu_torch.tools import k4_probe

    with open(f"{_build.SRC_DIR}/las_decoder.cu") as f:
        src = f.read()
    variants = {"old design": (*k4_probe.OLD_DESIGN, 1),
                "phases": (*k4_probe.TIMING, 1), **k4_probe.CUTS,
                "fwd old design": (*k4_probe.FWD_OLD_DESIGN, 1),
                "fwd phases": (*k4_probe.FWD_TIMING, 1),
                **{f"fwd {k}": v for k, v in k4_probe.FWD_CUTS.items()}}
    for name, (old, new, count) in variants.items():
        assert src.count(old) == count, name
        assert new != old, name
    assert len(k4_probe.PHASES) == 16
    assert len(k4_probe.FWD_PHASES) == src.count("    K4F_PHASE(") == 13
    assert set(k4_probe.FWD_MODE_CUTS) <= set(k4_probe.FWD_CUTS)
