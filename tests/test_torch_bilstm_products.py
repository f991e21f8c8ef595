"""PyTorch port, K1-bwd's products (dx, dW_x, dW_h, db after the reverse
sweep) on the CPU: what of them can run without the card.

- (a) The plain twin ``ops/bilstm.py::bilstm_fused_bwd_products_plain``,
  split out of ``bilstm_fused_bwd_plain`` and the sweep's dW_h, gives bit
  for bit what the backward gave before the split (``_before_split``
  below is that code, verbatim but for its names); the whole K1-bwd on
  the CPU still matches ``jax.vjp`` of the JAX package's ``bilstm_fused``
  (its backward Pallas kernel in interpret mode) at two layers' shapes,
  H=16, at the tolerances of ``tests/test_torch_bilstm_grad.py`` (f32
  rtol 1e-4 / atol 1e-5; bf16 3e-2 of each gradient's largest
  magnitude).
- (b) A NumPy emulation of the schedule of the bf16 kernels
  (``csrc/gemm_sm90.cuh``: ``dx_kernel``, ``wgrad_kernel`` and their
  host launchers), mirrored from the source with its constants read from
  it: the (b, t-tile) unit list, the dead-unit skip, the split-K ranges,
  the block decode, the tensor maps' boxes with their out-of-bounds
  zeros (the masks at K and at the time shift) and the epilogue's masks
  at M and N. It shows that every output element sums every live frame
  exactly once (and, for dW_h, the right h_prev row), and, summing the
  emulated boxes in f64, that the products equal the plain twin's. Also
  the 128-byte swizzle as a permutation and the converters' thread maps
  as covers. At the four shapes of ``tools/k1b_probe.py`` and at ragged
  ones.

The kernels themselves run only on the card
(``tests/test_torch_cuda_bilstm.py``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.models.lstm import matmul_cd, work_dtype
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

NAMES = ("dx", "dw_x", "db", "dw_hf", "dw_hb")
SRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                   "gemm_sm90.cuh")


def _layer(B, T, D, H, seed, lens=None):
    rng = np.random.RandomState(seed)
    if lens is None:
        lens = rng.randint(1, T + 1, size=B).astype(np.int32)
        lens[0] = T
        lens[-1] = 1
    a = {"x": rng.randn(B, T, D).astype(np.float32),
         "lens": np.asarray(lens, np.int32),
         "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
         "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
         "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
         "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)}
    return a, rng.randn(B, T, 2 * H).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the split plain twin
# ---------------------------------------------------------------------------


def _sweep_before_split(xg, lens, w_hf, w_hb, y, c, dy, compute_dtype):
    """``ops/bilstm.py::_bwd_sweep`` as it was before the split: it also
    formed dW_h."""
    B, T, _ = xg.shape
    H = w_hf.shape[0]
    work = work_dtype(xg, y)
    valid = (torch.arange(T, device=xg.device)[None, :] < lens[:, None])
    vm = valid[..., None].to(work)
    dy = dy.to(work) * vm
    y, c = y.to(work), c.to(work)
    zero = torch.zeros(B, 1, H, device=xg.device, dtype=work)
    dgs, dwh = [], []
    for d, w_h in enumerate((w_hf, w_hb)):
        hs, cs = y[..., d * H:(d + 1) * H], c[..., d * H:(d + 1) * H]
        if d == 0:
            h_prev = torch.cat([zero, hs[:, :-1]], 1)
            c_prev = torch.cat([zero, cs[:, :-1]], 1)
        else:
            h_prev = torch.cat([hs[:, 1:], zero], 1)
            c_prev = torch.cat([cs[:, 1:], zero], 1)
        gates = xg[..., d * 4 * H:(d + 1) * 4 * H] \
            + matmul_cd(h_prev, w_h, compute_dtype)
        gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
        si, sf = torch.sigmoid(gi) * vm, torch.sigmoid(gf + 1.0) * vm
        tg, so = torch.tanh(gg) * vm, torch.sigmoid(go) * vm
        th = torch.tanh(cs)
        dh_rec = torch.zeros(B, H, device=xg.device, dtype=work)
        dc_carry = torch.zeros_like(dh_rec)
        dg = torch.empty(B, T, 4 * H, device=xg.device, dtype=work)
        for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
            dh = dy[:, t, d * H:(d + 1) * H] + dh_rec
            d_o = dh * th[:, t]
            dc = dh * so[:, t] * (1.0 - th[:, t] ** 2) + dc_carry
            g = torch.cat([
                dc * tg[:, t] * si[:, t] * (1.0 - si[:, t]),
                dc * c_prev[:, t] * sf[:, t] * (1.0 - sf[:, t]),
                dc * si[:, t] * (1.0 - tg[:, t] ** 2),
                d_o * so[:, t] * (1.0 - so[:, t]),
            ], dim=-1)
            dh_rec = matmul_cd(g, w_h.T, compute_dtype)
            dc_carry = dc * sf[:, t]
            dg[:, t] = g
        dgs.append(dg)
        dwh.append(matmul_cd(h_prev.reshape(-1, H).T, dg.reshape(-1, 4 * H),
                             compute_dtype))
    return torch.cat(dgs, -1), dwh[0], dwh[1]


def _before_split(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy, compute_dtype,
                  round_xg):
    """``bilstm_fused_bwd_plain`` as it was before the split."""
    B, T, D = x.shape
    H = w_hf.shape[0]
    xg = torch.cat(K._project(x, lens, w_x, b_x, compute_dtype, round_xg), -1)
    dg, dw_hf, dw_hb = _sweep_before_split(xg, lens, w_hf, w_hb, y, c, dy,
                                           compute_dtype)
    dx = matmul_cd(dg, w_x.T, compute_dtype)
    dw_x = matmul_cd(x.reshape(-1, D).T, dg.reshape(-1, 8 * H), compute_dtype)
    return dx, dw_x, dg.sum((0, 1)), dw_hf, dw_hb


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cd,round_xg", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
@pytest.mark.parametrize("B,T,D,H", [(4, 12, 5, 6), (3, 70, 16, 16)])
def test_split_twin_is_bit_for_bit_the_backward_before_the_split(
        B, T, D, H, cd, round_xg, dtype):
    a, dy = _layer(B, T, D, H, seed=B + T)
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    for i in (0, 2, 3, 4, 5):
        ins[i] = ins[i].to(dtype)
    dyt = torch.from_numpy(dy).to(dtype)
    y, c = K.bilstm_fused_plain(*ins, compute_dtype=cd, round_xg=round_xg,
                                with_cell=True)
    calls = K.bilstm_fused_bwd_products_plain.calls
    got = K.bilstm_fused_bwd_plain(*ins, y, c, dyt, cd, round_xg)
    assert K.bilstm_fused_bwd_products_plain.calls == calls + 1
    want = _before_split(*ins, y, c, dyt, cd, round_xg)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    # the twin alone, on the sweep's dg
    x, lens, w_x, b_x = ins[:4]
    xg = torch.cat(K._project(x, lens, w_x, b_x, cd, round_xg), -1)
    dg = K._bwd_sweep(xg, lens, ins[4], ins[5], y, c, dyt, cd)
    for name, g, w in zip(NAMES, K.bilstm_fused_bwd_products_plain(
            x, lens, w_x, y, dg, cd), want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_k1_bwd_on_the_cpu_matches_jax_vjp(layer, cd):
    """Two layers' shapes of a small pyramid, H=16: layer 0 over features
    (D=12), layer 1 over the first layer's output (D=2H)."""
    H = 16
    B, T, D = (5, 23, 12) if layer == 0 else (5, 12, 2 * H)
    a, dy = _layer(B, T, D, H, seed=17 + layer)
    x, lens, w_x, b_x, w_hf, w_hb = (jnp.asarray(v) for v in a.values())
    _, vjp = jax.vjp(
        lambda x, w_x, b_x, w_hf, w_hb: jax_bilstm_fused(
            x, lens, w_x, b_x, w_hf, w_hb, jnp.dtype(cd), 8),
        x, w_x, b_x, w_hf, w_hb)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    ins = [torch.from_numpy(np.ascontiguousarray(v)) for v in a.values()]
    for i in (0, 2, 3, 4, 5):
        ins[i].requires_grad_(True)
    y = K.bilstm_fused(*ins, compute_dtype=getattr(torch, cd))
    got = torch.autograd.grad(y, [ins[i] for i in (0, 2, 3, 4, 5)],
                              torch.from_numpy(dy))
    for name, g, r in zip(NAMES, got, ref):
        if cd == "float32":
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            err = np.abs(g.numpy() - r).max() / np.abs(r).max()
            assert err <= 3e-2, (name, err)


def test_products_kernel_wrapper_refuses_cpu_tensors():
    a, _ = _layer(3, 5, 4, 8, seed=0)
    x, lens, w_x = (torch.from_numpy(np.ascontiguousarray(a[k]))
                    for k in ("x", "lens", "w_x"))
    n = K.bilstm_fused_bwd_products_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.bilstm_fused_bwd_products_kernel(x, lens, w_x, torch.zeros(3, 5, 16),
                                           torch.zeros(3, 5, 64))
    assert K.bilstm_fused_bwd_products_kernel.launches == n


# ---------------------------------------------------------------------------
# (b) the schedule of the bf16 kernels, emulated
# ---------------------------------------------------------------------------


def _constants():
    with open(SRC) as f:
        text = f.read()
    got = {name: int(v) for name, v in
           re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    for name in ("kBM", "kBN", "kBK", "kUnit", "kProducers"):
        assert name in got, name
    return got


C = _constants()
BM, BN, BK, UNIT = C["kBM"], C["kBN"], C["kBK"], C["kUnit"]
PRODUCERS = 128 * C["kProducers"]  # the converting threads
SMS = 132  # the H100's

# tools/k1b_probe.py's shapes (B, T, D, H), then ragged ones: B=1 and
# T=1, T a multiple of the unit and one past it, odd widths, H=256.
PROBE_SHAPES = [(96, 398, 80, 320), (96, 199, 1280, 320), (96, 100, 1280, 320),
                (16, 398, 80, 256)]
RAGGED = [(1, 1, 80, 256), (3, 19, 12, 8), (5, 37, 33, 40), (2, 64, 16, 16),
          (2, 65, 16, 16), (9, 50, 130, 130), (4, 130, 20, 24)]


def _lens(B, T, seed, ones=False):
    rng = np.random.RandomState(seed)
    lens = np.ones(B, np.int32) if ones else rng.randint(1, T + 1, size=B)
    lens[0] = 1 if ones else T
    return lens.astype(np.int32)


def sw128_at(r, c):
    """gemm_sm90.cuh::sw128_at: byte offset of chunk c of row r."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def wgrad_splits(tiles, units, sms):
    """gemm_sm90.cuh::wgrad_splits."""
    want = (2 * sms + tiles - 1) // tiles
    most = max(units // 16, 1)
    return min(want, most)


def h_column(H):
    """The backward direction's first column in y as the wrapper hands y
    to the bf16 products (``ops/bilstm.py::_h_rows``)."""
    return K._h_rows(torch.zeros(1, 1, 2 * H))[1]


def wgrad_jobs(B, T, D, H, with_x=True):
    """launch_wgrad's job list: (name, M, N, from_y, a_col0, shift,
    b_col0, mt, nt, first) and the splits."""
    jobs, tiles = [], 0
    yb = h_column(H)
    spec = ([("dw_x", D, 8 * H, 0, 0, 0, 0)] if with_x else []) + [
        ("dw_hf", H, 4 * H, 1, 0, -1, 0), ("dw_hb", H, 4 * H, 1, yb, 1, 4 * H)]
    for name, M, N, from_y, a_col0, shift, b_col0 in spec:
        mt, nt = -(-M // BM), -(-N // BN)
        jobs.append([name, M, N, from_y, a_col0, shift, b_col0, mt, nt, 0])
        tiles += mt * nt
    U = -(-T // UNIT)
    splits = wgrad_splits(tiles, B * U, SMS)
    first = 0
    for j in jobs:
        j[9] = first
        first += j[7] * j[8] * splits
    return jobs, splits, first


def persistent(tiles):
    """The tiles each persistent block walks: block b of min(tiles, SMS)
    takes b, b + G, b + 2G, ..."""
    G = min(tiles, SMS)
    return [list(range(b, tiles, G)) for b in range(G)]


def wgrad_block(bid, jobs, splits, B, T):
    """WgradPlan::tile, the decode of tile bid: (job, m0, n0, begin,
    end)."""
    job = jobs[0]
    for j in jobs[1:]:
        if bid >= j[9]:
            job = j
    local = bid - job[9]
    m0 = local % job[7] * BM
    local //= job[7]
    n0 = local % job[8] * BN
    split = local // job[8]
    units = B * -(-T // UNIT)
    return (job, m0, n0, split * units // splits,
            (split + 1) * units // splits)


def live_units(begin, end, lens, T):
    """The units the producer and the consumers walk: wgrad_kernel's
    ``live``."""
    U = -(-T // UNIT)
    return [u for u in range(begin, end) if (u % U) * UNIT < lens[u // U]]


def box(a, c0, c1, rows, cols):
    """A TMA box of a [T, cols] slice of a 3-D map (the b coordinate
    fixed): rows c1 .. c1 + rows, columns c0 .. c0 + cols, 0 out of
    bounds."""
    out = np.zeros((rows, cols), a.dtype)
    T, W = a.shape
    r0, r1 = max(c1, 0), min(c1 + rows, T)
    k0, k1 = max(c0, 0), min(c0 + cols, W)
    if r0 < r1 and k0 < k1:
        out[r0 - c1:r1 - c1, k0 - c0:k1 - c0] = a[r0:r1, k0:k1]
    return out


@pytest.mark.parametrize("B,T,D,H", PROBE_SHAPES + RAGGED)
def test_wgrad_schedule_sums_every_live_frame_once(B, T, D, H):
    lens = _lens(B, T, seed=B + T)
    jobs, splits, blocks = wgrad_jobs(B, T, D, H)
    # the persistent blocks take every tile once; the decode is a bijection
    # onto (job, m-tile, n-tile, split)
    walks = persistent(blocks)
    assert sorted(t for w in walks for t in w) == list(range(blocks))
    seen = set()
    for bid in range(blocks):
        job, m0, n0, begin, end = wgrad_block(bid, jobs, splits, B, T)
        seen.add((job[0], m0, n0, begin))
    assert len(seen) == blocks == sum(j[7] * j[8] for j in jobs) * splits
    # every tile of a job walks the same splits: count the frames they add
    U = -(-T // UNIT)
    bounds = [wgrad_block(jobs[0][9] + s * jobs[0][7] * jobs[0][8], jobs,
                          splits, B, T)[3:] for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == B * U
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(splits - 1))
    count = np.zeros((B, T), np.int64)
    for begin, end in bounds:
        for u in live_units(begin, end, lens, T):
            b, t0 = u // U, (u % U) * UNIT
            count[b, t0:min(t0 + UNIT, T)] += 1  # rows past T: zero fill
    t = np.arange(T)[None, :]
    live = t < lens[:, None]
    assert (count[live] == 1).all()  # every live frame exactly once
    assert (count <= 1).all()  # a dead frame at most once, where dg is 0
    # the h_prev row of frame (b, t) in each direction's box
    for name, shift in (("dw_hf", -1), ("dw_hb", 1)):
        src = t + shift
        want = np.where((src >= 0) & (src < T), src, -1)
        for t0 in range(0, T, UNIT):
            rows = np.arange(t0, t0 + UNIT) + shift  # the box's rows
            inside = (rows >= 0) & (rows < T)
            k = np.arange(t0, min(t0 + UNIT, T))
            assert np.array_equal(np.where(inside[:len(k)], rows[:len(k)], -1),
                                  want[0, k]), name


@pytest.mark.parametrize("B,T,D,H", PROBE_SHAPES + RAGGED)
def test_dx_schedule_writes_every_row_once(B, T, D, H):
    lens = _lens(B, T, seed=B + T)
    U = -(-T // UNIT)
    ntiles = -(-D // BN)
    blocks = (B * U + 1) // 2 * ntiles
    assert sorted(t for w in persistent(blocks) for t in w) == list(range(blocks))
    written = np.zeros((B, T, ntiles), np.int64)
    product = np.zeros((B, T), bool)
    for bid in range(blocks):
        q, nt = divmod(bid, ntiles)
        for w in range(2):
            u = 2 * q + w
            if u >= B * U:
                continue
            b, t0 = u // U, (u % U) * UNIT
            rows = slice(t0, min(t0 + UNIT, T))  # the epilogue's t < T
            written[b, rows, nt] += 1
            product[b, rows] = t0 < lens[b]
    assert (written == 1).all()  # every row and column tile once
    live = np.arange(T)[None, :] < lens[:, None]
    assert (product[live]).all()  # a live frame always from the product
    # the k-steps cover 8H, the last one's columns past 8H zero-filled
    steps = -(-8 * H // BK)
    assert steps * BK >= 8 * H > (steps - 1) * BK


@pytest.mark.parametrize("B,T,D,H,ones", [(3, 19, 12, 8, False),
                                          (5, 37, 33, 40, False),
                                          (2, 130, 20, 24, True),
                                          (1, 1, 16, 16, False),
                                          (4, 70, 136, 20, False)])
def test_emulated_products_equal_the_plain_twin(B, T, D, H, ones):
    """Every block of both kernels summed from its boxes in f64, with the
    epilogue's masks, against the plain twin in f64 on a dg that is 0 past
    lens (as the recurrence writes it)."""
    lens = _lens(B, T, seed=B + T + D, ones=ones)
    rng = np.random.RandomState(B * T)
    x = rng.randn(B, T, D)
    y = rng.randn(B, T, 2 * H) * (np.arange(T)[None, :, None]
                                   < lens[:, None, None])
    dg = rng.randn(B, T, 8 * H) * (np.arange(T)[None, :, None]
                                    < lens[:, None, None])
    w_x = rng.randn(D, 8 * H)
    y_maps = K._h_rows(torch.from_numpy(y))[0].numpy()  # as the wrapper lays y
    U = -(-T // UNIT)
    # dx_kernel
    dx = np.full((B, T, D), np.nan)
    ntiles = -(-D // BN)
    for bid in range((B * U + 1) // 2 * ntiles):
        q, nt = divmod(bid, ntiles)
        n0 = nt * BN
        for w in range(2):
            u = 2 * q + w
            if u >= B * U:
                continue
            b, t0 = u // U, (u % U) * UNIT
            acc = np.zeros((UNIT, BN))
            if t0 < lens[b]:
                for k in range(0, 8 * H, BK):
                    acc += box(dg[b], k, t0, UNIT, BK) @ box(w_x, k, n0, BN, BK).T
            rows = min(t0 + UNIT, T) - t0
            cols = min(n0 + BN, D) - n0
            dx[b, t0:t0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    # wgrad_kernel
    outs = {"dw_x": np.zeros((D, 8 * H)), "dw_hf": np.zeros((H, 4 * H)),
            "dw_hb": np.zeros((H, 4 * H))}
    jobs, splits, blocks = wgrad_jobs(B, T, D, H)
    for bid in range(blocks):
        job, m0, n0, begin, end = wgrad_block(bid, jobs, splits, B, T)
        name, M, N, from_y, a_col0, shift, b_col0 = job[:7]
        acc = np.zeros((BM, BN))
        for u in live_units(begin, end, lens, T):
            b, t0 = u // U, (u % U) * UNIT
            a = box(y_maps[b] if from_y else x[b], a_col0 + m0, t0 + shift,
                    UNIT, BM)
            acc += a.T @ box(dg[b], b_col0 + n0, t0, UNIT, BN)
        rows, cols = min(m0 + BM, M) - m0, min(n0 + BN, N) - n0
        outs[name][m0:m0 + rows, n0:n0 + cols] += acc[:rows, :cols]
    t64 = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = K.bilstm_fused_bwd_products_plain(
        t64(x), t64(lens), t64(w_x), t64(y), t64(dg), torch.float32)
    got = (dx, outs["dw_x"], None, outs["dw_hf"], outs["dw_hb"])
    for name, g, w in zip(NAMES, got, want):
        if g is not None:
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("B,T,D,H", PROBE_SHAPES + RAGGED)
def test_every_box_starts_on_a_16_byte_boundary(B, T, D, H):
    """The TMA takes a box only where its start along a row (and every row
    stride) is a multiple of 16 bytes: 4 floats. x's rows are padded to
    it by the wrapper; the columns where boxes start are checked here."""
    jobs, splits, blocks = wgrad_jobs(B, T, D, H)
    for bid in range(blocks):
        job, m0, n0, _, _ = wgrad_block(bid, jobs, splits, B, T)
        assert (job[4] + m0) % 4 == 0 and (job[6] + n0) % 4 == 0, job[0]
    y_rows = K._h_rows(torch.zeros(1, 1, 2 * H))[0].shape[-1]
    assert y_rows % 4 == 0 and (8 * H) % 4 == 0
    assert all(k % 4 == 0 for k in range(0, 8 * H, BK))  # dx's depth
    assert all(n0 % 4 == 0 for n0 in range(0, D, BN))  # W_x's rows: any


@pytest.mark.parametrize("H", [6, 8, 130, 320])
def test_h_rows_keep_each_direction_where_the_maps_read_it(H):
    y = torch.arange(2 * 3 * 2 * H, dtype=torch.float32).reshape(2, 3, 2 * H)
    yl, yb = K._h_rows(y)
    assert yb % 4 == 0 and yl.shape[-1] % 4 == 0 and yb >= H
    assert torch.equal(yl[..., :H], y[..., :H])
    assert torch.equal(yl[..., yb:yb + H], y[..., H:])
    assert (yl[..., H:yb] == 0).all() and (yl[..., yb + H:] == 0).all()
    assert (yl is y) == (H % 4 == 0)


def test_swizzle_is_a_permutation_within_each_8_row_group():
    for r0 in range(0, BM, 8):
        offs = sorted(sw128_at(r, c) for r in range(r0, r0 + 8)
                      for c in range(BK // 8))
        assert offs == [r0 * 128 + 16 * i for i in range(64)]
    # the hardware's 128-byte swizzle on the (1024-byte aligned) address:
    # bits 4-6 XOR bits 7-9
    for r in range(BM):
        for c in range(BK // 8):
            plain = r * 128 + c * 16
            assert sw128_at(r, c) == plain ^ (((plain >> 7) & 7) << 4)
    # a k16 step of the descriptor is 32 bytes further in the row: chunk
    # 2j + e of row r is where the producer stored k = 16j + 8e .. + 7
    for j in range(BK // 16):
        for r in range(8):
            for e in range(2):
                addr = r * 128 + 32 * j + 16 * e
                assert addr ^ (((addr >> 7) & 7) << 4) == sw128_at(r, 2 * j + e)


def test_converters_cover_each_chunk_once_without_bank_conflicts():
    # convert_k: thread p, pass i: row R i + p / 8, chunk p % 8
    rows = PRODUCERS // 8
    cover = sorted((i * rows + (p >> 3), p & 7) for p in range(PRODUCERS)
                   for i in range(BM // rows))
    assert cover == [(r, c) for r in range(BM) for c in range(BK // 8)]
    for p0 in range(0, PRODUCERS, 8):  # a 16-byte access phase: 8 lanes
        lanes = range(p0, p0 + 8)
        r = p0 >> 3
        for first in (True, False):
            banks = set()
            for p in lanes:
                c = p & 7
                h = (c >> 2) & 1
                half = h if first else h ^ 1
                off = r * BK * 4 + c * 32 + 16 * half
                banks.update((off // 4 + i) % 32 for i in range(4))
            assert len(banks) == 32
        assert len({sw128_at(r, p & 7) % 128 for p in lanes}) == 8
    # convert_mn: thread p owns column p % 128 and its warpgroup's chunks
    chunks = BK // 8 // C["kProducers"]
    cover = sorted((p % BM, c) for p in range(PRODUCERS)
                   for c in range(p // BM * chunks, (p // BM + 1) * chunks))
    assert cover == [(r, c) for r in range(BM) for c in range(BK // 8)]
    for c in range(BK // 8):
        for p0 in range(0, 128, 8):
            assert len({sw128_at(p, c) % 128 for p in range(p0, p0 + 8)}) == 8
