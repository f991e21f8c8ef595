"""PyTorch port, K4-fwd's cluster kernel (``csrc/las_decoder.cu::
fwd_cluster_kernel``) on the CPU: what of it can run without the card.

- the wrapper's per-CTA slices of the gate and query weights
  (``ops/las_decoder.py::_cluster_slices`` of [W_x; W_h]^T and att_q^T)
  hold every weight once, where the kernel's header says;
- a torch emulation of the kernel's decomposition: clusters of 8 CTAs,
  each owning one batch row, a slice of the H units (their four gates)
  and a slice of the A query columns; the gate and query products split
  by those columns and by depth splits summed in ``cl_product``'s order;
  the gate input by step parity; the three exchanges (h to every CTA, q
  to the row's CTA, ctx and the next token to every CTA) as copies; the
  row's own phases at one row (scores, loc's feature as the convolution
  with the filter, the masked softmax, the context, the logits and the
  argmax). Held against ``las_decoder_fwd_plain`` in dot, add and loc,
  f32 and bf16, with the scheduled-sampling coins off and on, for the
  logits and every residual, the saved gate activations and query
  among them; and, in f32, against the JAX package's forward of
  ``las_decoder_fused`` (``las_decoder_fwd``, its Pallas kernel in
  interpret mode, as ``tests/test_pallas_decoder.py`` runs it);
- the kernel chosen by shape alone (``fwd_route``), and CPU tensors
  taking the plain version.

The kernel itself runs only on the card (``tests/test_torch_cuda_decoder.py``).

Tolerances. f32 against the plain version: only the order of the sums
differs, 2e-5 of each output's largest magnitude (as
``tests/test_torch_las_decoder_cluster.py``), the fed-back tokens
identical. f32 against the JAX forward: 1e-5, as
``tests/test_pallas_decoder.py`` holds that kernel to its scan. bf16: both
sides round the same operands to bf16 and sum in f32 in another order:
1e-4 of the largest magnitude (the same file's bf16 tolerance), which a
sum on the other side of a rounding boundary, an operand of the next
step changed by one bf16 ulp (2^-8), would exceed. With the coins on in
bf16 such a flip could also change an argmax and a row's later inputs:
the rows whose fed-back tokens agree are compared, and most must agree
(all of them in f32 and with the coins off).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_decoder import (
    build_loc_band_cmajor as jax_band, las_decoder_fwd as jax_fwd)
from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

torch.set_num_threads(1)

R = K.CLUSTER_ROWS
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
TOL_JAX = 1e-5


def _r(x, cd):
    return x.to(cd).float()


def _gate_segments(H):
    return tuple((j * H, H) for j in range(4))


@pytest.mark.parametrize("H,K_", [(320, 1216), (12, 36), (70, 25)])
def test_gate_slices_hold_every_weight_once_where_the_header_says(H, K_):
    """[W_x; W_h]^T [4H, E+D+H]: CTA r's slice [K][4 HU] holds its units'
    i, f, g, o columns, gate j of local unit ul at column j*HU + ul."""
    m = torch.arange(1, 4 * H * K_ + 1, dtype=torch.float64).reshape(4 * H, K_)
    s = K._cluster_slices(m, _gate_segments(H))
    HU = K._cluster_units(H)
    assert s.shape == (R, K_, 4 * HU) and s.is_contiguous()
    for r in range(R):
        for j in range(4):
            for ul in range(HU):
                u = r * HU + ul
                want = m[j * H + u] if u < H else torch.zeros(K_, dtype=m.dtype)
                assert torch.equal(s[r, :, j * HU + ul], want), (r, j, ul)
    vals = s[s != 0]
    assert torch.equal(torch.sort(vals).values, m.reshape(-1))


@pytest.mark.parametrize("A,H", [(320, 320), (8, 12), (44, 70)])
def test_query_slices_hold_every_weight_once_where_the_header_says(A, H):
    """att_q^T [A, H]: CTA r's slice [H][AU] holds query columns r*AU on."""
    m = torch.arange(1, A * H + 1, dtype=torch.float64).reshape(A, H)
    s = K._cluster_slices(m, ((0, A),))
    AU = K._cluster_units(A)
    assert s.shape == (R, H, AU)
    for r in range(R):
        for al in range(AU):
            a = r * AU + al
            want = m[a] if a < A else torch.zeros(H, dtype=m.dtype)
            assert torch.equal(s[r, :, al], want), (r, al)
    vals = s[s != 0]
    assert torch.equal(torch.sort(vals).values, m.reshape(-1))


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def _case(B, L, T, D, A, E, H, V, kind, seed, coin_p=0.0, C=3, W=5):
    """(tokens, coins, enc, enc_proj, enc_len, weights, filter [W,1,C] or
    None) from numpy: the last row has no frames, the first all T."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    enc_len = rng.randint(1, T + 1, size=B).astype(np.int32)
    enc_len[0], enc_len[-1] = T, 0
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    coins = rng.rand(B, L) < coin_p
    coins[:, 0] = False
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
    return (torch.from_numpy(tokens), torch.from_numpy(coins), enc, enc_proj,
            torch.from_numpy(enc_len), w, filt)


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


def _feature(att_prev, filt, n, cd):
    """loc_feature_row: the rounded previous weights convolved with the
    rounded filter [W, C] over the row's n frames, rounded; [C, T]."""
    Wd, C = filt.shape
    pad = (Wd - 1) // 2
    f = torch.zeros(C, att_prev.shape[0])
    for t in range(n):
        for k in range(max(0, pad - t), min(Wd, n - t + pad)):
            f[:, t] += att_prev[t + k - pad] * filt[k]
    return _r(f, cd)


def _emulate(case, kind, cd):
    """fwd_cluster_kernel's outputs, every cluster of ceil(B / 8) run step
    by step: (logits, (h, c, att, ctx, tok), (acts, q))."""
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    B, L = tokens.shape
    _, T, D = enc.shape
    H, E, A, V = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1], w.embed.shape[0]
    HU, AU, KX = K._cluster_units(H), K._cluster_units(A), E + D + H
    Sg, Sq = K._cluster_splits(HU, KX), K._cluster_splits(AU // 4, H)
    r = lambda x: _r(x, cd)  # noqa: E731
    wcat = torch.cat([w.w_x, w.w_h], 0)
    sl_gates = K._cluster_slices(wcat.T, _gate_segments(H))
    sl_query = K._cluster_slices(w.att_q.T, ((0, A),))
    out = {"logits": torch.zeros(B, L, V), "h": torch.zeros(B, L, H),
           "c": torch.zeros(B, L, H), "att": torch.zeros(B, L, T),
           "ctx": torch.zeros(B, L, D), "tok": torch.zeros(B, L, dtype=torch.long),
           "acts": torch.zeros(B, L, 4 * H), "q": torch.zeros(B, L, A)}
    loc = kind == "loc"
    if loc:
        filt_r, locp_r = r(filt[:, 0, :]), r(w.loc_proj)
    for b0 in range(0, B, R):
        rows = [b0 + k for k in range(R)]
        live = [b < B for b in rows]
        gin = torch.zeros(2, R, KX)   # by step parity: [row][emb; ctx; h]
        cs = torch.zeros(R, R, HU)    # [CTA][row][its units]
        attp = torch.zeros(R, T)      # loc: the row's previous weights
        tok = [int(tokens[b, 0]) if live[k] and not coins[b, 0] else 0
               for k, b in enumerate(rows)]
        for i in range(L):
            cur, nxt = gin[i % 2], gin[(i + 1) % 2]
            # (a) the embeddings
            for k, b in enumerate(rows):
                cur[k, :E] = r(w.embed[tok[k]]) if live[k] else 0.0
                if live[k]:
                    out["tok"][b, i] = tok[k]
            # (b) each CTA's gates and cells; exchange 1 into nxt's h
            gates = _product(cur, sl_gates, Sg, cd)
            for k in range(R):
                u0, nu = k * HU, max(0, min(HU, H - k * HU))
                if nu == 0:
                    continue
                g = [w.b_x[j * H + u0:j * H + u0 + nu] + gates[k][:, j * HU:j * HU + nu]
                     for j in range(4)]
                acts = [torch.sigmoid(g[0]), torch.sigmoid(g[1] + 1.0),
                        torch.tanh(g[2]), torch.sigmoid(g[3])]
                c = acts[1] * cs[k, :, :nu] + acts[0] * acts[2]
                h = acts[3] * torch.tanh(c)
                cs[k, :, :nu] = c
                nxt[:, E + D + u0:E + D + u0 + nu] = r(h)
                for rr, b in enumerate(rows):
                    if live[rr]:
                        out["h"][b, i, u0:u0 + nu] = h[rr]
                        out["c"][b, i, u0:u0 + nu] = c[rr]
                        for j in range(4):
                            out["acts"][b, i, j * H + u0:j * H + u0 + nu] = acts[j][rr]
            # (c) each CTA's query columns; exchange 2 into the row's CTA
            qp = _product(nxt[:, E + D:], sl_query, Sq, cd)
            q = torch.zeros(R, A)
            for k in range(R):
                a0, na = k * AU, max(0, min(AU, A - k * AU))
                if na:
                    q[:, a0:a0 + na] = w.att_b[a0:a0 + na] + qp[k][:, :na]
            # (d) each row's phases; exchange 3 into nxt's ctx and tok
            for rr, b in enumerate(rows):
                if not live[rr]:
                    tok[rr] = 0
                    continue
                out["q"][b, i] = q[rr]
                n = int(enc_len[b])
                encp = r(enc_proj[b, :n])
                if kind == "dot":
                    s = (encp @ q[rr]) * K._scale(A)
                else:
                    e = encp + q[rr]
                    if loc:
                        f = _feature(attp[rr], filt_r, n, cd)
                        e = e + f[:, :n].T @ locp_r
                    s = (torch.tanh(e) * w.att_v[:, 0]).sum(-1)
                att = torch.zeros(T)
                if n:
                    p = torch.exp(s - s.max())
                    att[:n] = p / p.sum()
                ctx = r(att[:n]) @ r(enc[b, :n])
                logits = torch.cat([nxt[rr, E + D:], r(ctx)]) @ r(w.w_out) + w.b_out
                out["att"][b, i], out["ctx"][b, i] = att, ctx
                out["logits"][b, i] = logits
                if i + 1 < L:
                    tok[rr] = (int(torch.argmax(logits)) if coins[b, i + 1]
                               else int(tokens[b, i + 1]))
                nxt[rr, E:E + D] = r(ctx)
                attp[rr] = r(att)
    return out["logits"], tuple(out[k] for k in ("h", "c", "att", "ctx", "tok")), (
        out["acts"], out["q"])


def _reference(case, kind, cd):
    """las_decoder_fwd_plain and what the kernel saves beside its
    residuals, recomputed from them: the gate activations and the query."""
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
    return logits, resid, (acts, q)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


NAMES = ("logits", "h", "c", "att", "ctx", "acts", "q")

# B, L, T', D, A, E, H, V: two clusters, the second with 3 rows, every
# slice padded (H=12: CTAs 3-7 own no unit; A=8: CTAs 2-7 no query
# column); and B < 8 with widths that give most CTAs several units
SHAPES = [(11, 5, 9, 16, 8, 8, 12, 9), (5, 4, 13, 20, 44, 12, 70, 13)]


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coin_p", [0.0, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_cluster_forward_matches_plain(kind, cd, coin_p, shape):
    case = _case(*shape, kind, seed=2, coin_p=coin_p)
    got_logits, got_resid, got_extras = _emulate(case, kind, cd)
    ref_logits, ref_resid, ref_extras = _reference(case, kind, cd)
    same = (got_resid[4] == ref_resid[4].long()).all(1)
    if cd == torch.float32 or coin_p == 0.0:
        assert same.all()
    assert same.float().mean() >= 0.8
    if coin_p:  # the coins did feed back some argmax
        assert (ref_resid[4] != case[0]).any()
    got = (got_logits, *got_resid[:4], *got_extras)
    ref = (ref_logits, *ref_resid[:4], *ref_extras)
    for name, a, b in zip(NAMES, got, ref):
        assert _rel(a[same], b[same]) <= TOL[cd], (name, _rel(a[same], b[same]))
    # the row with no frames attends nowhere
    assert not got_resid[2][-1].any() and not got_resid[3][-1].any()


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("coin_p", [0.0, 0.5])
def test_emulated_cluster_forward_matches_jax(kind, coin_p):
    """The emulated f32 forward against the JAX package's forward of
    las_decoder_fused (its Pallas kernel in interpret mode)."""
    case = _case(*SHAPES[0], kind, seed=3, coin_p=coin_p)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    T = enc.shape[1]
    n = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    mask = (np.arange(T)[None] < enc_len.numpy()[:, None]).astype(np.float32)
    band = jax_band(n(filt), T) if kind == "loc" else None
    ref, resid = jax_fwd(
        jnp.asarray(tokens.numpy()), jnp.asarray(coins.numpy().astype(np.float32)),
        n(enc), n(enc_proj), jnp.asarray(mask), band, n(w.embed), n(w.w_x),
        n(w.b_x), n(w.w_h), n(w.att_q), n(w.att_b), n(w.att_v), n(w.loc_proj),
        n(w.w_out), n(w.b_out), compute_dtype="float32", l_chunk=4,
        is_dot=kind == "dot")
    logits, got, _ = _emulate(case, kind, torch.float32)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(resid[4]))
    for name, a, b in zip(("logits", "h", "c", "att", "ctx"),
                          (logits, *got[:4]), (ref, *resid[:4])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL_JAX,
                                   atol=TOL_JAX, err_msg=name)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

FLAGSHIP = dict(D=640, A=320, E=256, H=320, V=32, C=10, W=100)


@pytest.mark.parametrize("kind", K.ATT_KINDS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [100, 320])
def test_flagship_shapes_take_the_cluster_kernel(kind, cd, T):
    """The 4.0 s bucket and bench.py's T' at the flagships' widths."""
    dims = dict(FLAGSHIP) if kind == "loc" else dict(FLAGSHIP, C=0, W=0)
    assert K.fwd_route(kind, cd, T, **dims) == "cluster"


def test_route_by_shape_alone():
    f32 = torch.float32
    # a gate input (E+D+H = 3000) whose two buffers outgrow the cluster
    # plan: fwd_kernel
    assert K.fwd_route("dot", f32, 19, 2400, 8, 300, 300, 11) == "rows"
    # a vocabulary neither plan holds
    assert K.fwd_route("dot", f32, 19, 12, 8, 6, 8, 60000) is None
    # every shape fwd_kernel took still has a kernel
    rng = np.random.RandomState(0)
    seen = set()
    for _ in range(300):
        kind = K.ATT_KINDS[rng.randint(3)]
        cd = (torch.float32, torch.bfloat16)[rng.randint(2)]
        loc = kind == "loc"
        dims = dict(T=int(rng.randint(1, 700)), D=int(rng.randint(1, 2048)),
                    A=4 * int(rng.randint(1, 129)), E=int(rng.randint(1, 1024)),
                    H=int(rng.randint(1, 1025)), V=int(rng.randint(1, 30000)),
                    C=int(rng.randint(1, 17)) if loc else 0,
                    W=int(rng.randint(1, 200)) if loc else 0)
        cols = 8 if cd == torch.bfloat16 else 4
        args = (kind, *dims.values(), cols)
        old_fits = 4 * K._fwd_rows_plan(*args) <= K._MAX_SMEM
        new_fits = 4 * K._cluster_fwd_plan(*args) <= K._MAX_SMEM
        route = K.fwd_route(kind, cd, **dims)
        assert route == ("cluster" if new_fits else "rows" if old_fits else None)
        seen.add(route)
    assert seen == {"cluster", "rows", None}


def test_cpu_tensors_take_the_plain_version():
    case = _case(5, 3, 9, 16, 8, 8, 12, 9, "loc", seed=4)
    tokens, coins, enc, enc_proj, enc_len, w, filt = case
    fn = K.las_decoder_fwd_kernel
    before = (fn.launches, fn.cluster_launches, K.las_decoder_fwd_plain.calls)
    K.las_decoder(tokens, coins, enc, enc_proj, enc_len, w, torch.float32,
                  "loc", filt)
    enc = enc.clone().requires_grad_(True)
    K.las_decoder(tokens, coins, enc, enc_proj, enc_len, w, torch.float32,
                  "loc", filt).sum().backward()
    assert (fn.launches, fn.cluster_launches) == before[:2]
    assert K.las_decoder_fwd_plain.calls == before[2] + 2
    with pytest.raises(ValueError, match="CUDA"):
        fn(tokens, coins, enc.detach(), enc_proj, enc_len, w, torch.float32,
           "loc", filt)
