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

- (c) The f32 core (``csrc/gemm_f32.cuh::ring_kernel``, K1's f32
  projection and products) emulated the same way: its constants read
  from the source, its host plan (``f32_plan`` below mirrors
  ``gemm_f32.cuh::splits`` and ``csrc/bilstm_bwd.cu::f32_products``) in
  one wave of blocks, the walk over live frame tiles and its strided
  splits, the live-first row order, the products summed tile by
  tile in f64 against the plain twins, the thread maps as covers and its
  shared-memory reads free of bank conflicts.

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
from gluon_e2e_asr_tpu_torch.tools.k1b_probe import F32_OLD

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


# ---------------------------------------------------------------------------
# (c) the f32 core (csrc/gemm_f32.cuh's ring_kernel), emulated
# ---------------------------------------------------------------------------
#
# Its constants read from the source; its host plan (the k-split) in one
# wave of blocks; the walk over live frame tiles, the split
# ranges and the dead row tiles as ring_kernel takes them; its products
# (dx, dW_x with db from the staged dg tiles, dW_h) summed tile by tile
# against the plain twin; the thread maps of the loads, the products and
# the epilogue as covers, and its shared-memory reads free of bank
# conflicts.

F32_SRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                       "gemm_f32.cuh")

with open(F32_SRC) as _f:
    F32_TEXT = _f.read()
CF = {name: int(v) for name, v in
      re.findall(r"constexpr int (k\w+) = (\d+);", F32_TEXT)}
F_BM, F_BN, F_BK = CF["kBM"], CF["kBN"], CF["kBK"]
F_THREADS, F_SKEW = CF["kThreads"], CF["kSkew"]

# the milestones' layers (B=16, H=256, the 4.0 s bucket), then ragged ones
F32_PLAN_SHAPES = [(16, 398, 80, 256), (16, 199, 1024, 256),
                   (16, 100, 1024, 256), (96, 398, 80, 320), (1, 1, 80, 256),
                   (5, 37, 33, 130), (3, 19, 12, 8), (148, 398, 80, 256)]


def test_probes_old_f32_variant_edits_each_library_once():
    """The probes' F32_OLD (the build of the f32 route's first kernels that
    ``k1b_probe.py --products --dtype float32`` and ``k1f_probe.py --proj
    --dtype float32`` time beside ring_kernel): its text is in each
    library's source once, as _build.build_variants needs; chip_smoke.py
    builds no such variant."""
    (old, new), = F32_OLD["old"]
    assert new != old
    for name in ("bilstm_fwd", "bilstm_bwd"):
        with open(os.path.join(os.path.dirname(F32_SRC), f"{name}.cu")) as f:
            assert f.read().count(old) == 1, name
    with open(os.path.join(os.path.dirname(K.__file__), os.pardir, os.pardir,
                           "chip_smoke.py")) as f:
        assert "K1_F32_TILED" not in f.read()


def test_f32_core_constants_fit_the_emulation():
    assert F_BM == F_BN == 128 and F_THREADS == 256 and F_BK % 4 == 0
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in F32_TEXT
    assert CF["kBlocksPerSm"] >= 1 and CF["kMinTiles"] >= 1


def f32_splits(M, N, K_, sms):
    """gemm_f32.cuh::splits: the k-split of an M x N output of depth K_,
    the most splits that keep its blocks within one wave of kBlocksPerSm
    blocks on each of ``sms`` SMs, each split at least kMinTiles
    k-tiles."""
    tiles = -(-M // F_BM) * -(-N // F_BN)
    want = CF["kBlocksPerSm"] * sms // tiles
    most = -(-K_ // F_BK) // CF["kMinTiles"]
    s = min(want, most)
    return s if s > 1 else 1


def f32_live_tiles(lens, T):
    """The k-tiles of F_BK frames (b*T + t) holding a live frame (t <
    lens[b]): what the f32 weight gradients walk (``gemm_f32.cuh::
    Frames``)."""
    K_ = len(lens) * T
    return sum(f32_live(k0, lens, T) for k0 in range(0, K_, F_BK))


def f32_plan(lens, T, D, H, sms):
    """csrc/bilstm_bwd.cu::f32_products' launches at one layer (B =
    len(lens)), and the projection's: per product its output, depth,
    blocks of one split, splits and the k-tiles it walks (the weight
    gradients only the live ones). dx splits for half its rows (its
    blocks past the live frames exit at once); both directions' dW_h
    share a launch, split for their tiles together."""
    M = len(lens) * T
    live = f32_live_tiles(lens, T)
    out = {}
    for name, rows, cols, depth, walked, plan_rows in (
            ("projection", M, 8 * H, D, None, None),
            ("dx", M, D, 8 * H, None, -(-M // 2)),
            ("dw_x", D, 8 * H, M, live, D), ("dw_h", H, 4 * H, M, live, 2 * H)):
        splits = 1 if plan_rows is None else f32_splits(plan_rows, cols,
                                                         depth, sms)
        out[name] = {"M": rows, "N": cols, "K": depth,
                     "tiles": -(-rows // F_BM) * -(-cols // F_BN),
                     "splits": splits,
                     "k_tiles": walked if walked is not None
                     else -(-depth // F_BK)}
    return out


@pytest.mark.parametrize("B,T,D,H", F32_PLAN_SHAPES)
def test_f32_plan_keeps_one_wave_of_blocks(B, T, D, H):
    lens = _lens(B, T, seed=B + T)
    M = B * T
    plan = f32_plan(lens, T, D, H, SMS)
    # dx plans for half its rows; both directions' dW_h share a launch
    for name, rows, cols, depth, jobs in (
            ("dx", -(-M // 2), D, 8 * H, 1), ("dw_x", D, 8 * H, M, 1),
            ("dw_h", 2 * H, 4 * H, M, 2)):
        got = plan[name]
        blocks = -(-rows // F_BM) * -(-cols // F_BN) * got["splits"]
        # one wave of two blocks an SM, unless one split already fills it
        assert blocks <= CF["kBlocksPerSm"] * SMS or got["splits"] == 1
        # each split walks at least kMinTiles k-tiles
        assert got["splits"] == 1 \
            or -(-depth // F_BK) // got["splits"] >= CF["kMinTiles"]
        assert got["tiles"] * jobs >= -(-rows // F_BM) * -(-cols // F_BN)
    assert plan["projection"]["splits"] == 1
    assert plan["dw_x"]["k_tiles"] <= -(-M // F_BK)


def f32_ranges(K_, splits):
    """The k-tiles of each split (ring_kernel): split z of S takes z, z + S,
    z + 2S, ..."""
    ktiles = -(-K_ // F_BK)
    nsplit = min(max(splits, 1), ktiles)
    return [range(z, ktiles, nsplit) for z in range(nsplit)]


def f32_live(k0, lens, T):
    """gemm_f32.cuh::Frames::live."""
    K_ = len(lens) * T
    k1 = min(k0 + F_BK, K_)
    b = k0 // T
    while b * T < k1:
        if max(k0, b * T) - b * T < lens[b]:
            return True
        b += 1
    return False


@pytest.mark.parametrize("B,T,D,H", F32_PLAN_SHAPES)
def test_f32_walk_covers_every_live_frame_once(B, T, D, H):
    lens = _lens(B, T, seed=B * T)
    K_ = B * T
    frames = np.arange(K_)
    live_frame = frames % T < lens[frames // T]
    for splits in (1, f32_splits(D, 8 * H, K_, SMS),
                   f32_splits(2 * H, 4 * H, K_, SMS)):
        seen = np.zeros(K_, int)
        walked = 0
        for tiles in f32_ranges(K_, splits):
            for t in tiles:
                rows = frames[t * F_BK:(t + 1) * F_BK]
                live = f32_live(t * F_BK, lens, T)
                assert live == bool(live_frame[rows].any())
                if live:
                    seen[rows] += 1
                    walked += 1
        assert (seen[live_frame] == 1).all()
        assert walked == f32_live_tiles(lens, T)


@pytest.mark.parametrize("B,T,D,H", F32_PLAN_SHAPES[:4])
def test_f32_splits_spread_the_live_tiles(B, T, D, H):
    """Split z of S takes every S-th k-tile: each utterance's live prefix
    gives every split its share, give or take one tile, so no split walks
    more than its even share plus B (contiguous ranges of tiles gave some
    splits far more)."""
    lens = _lens(B, T, seed=B * T)
    K_ = B * T
    for splits in (f32_splits(D, 8 * H, K_, SMS), f32_splits(2 * H, 4 * H, K_, SMS)):
        walked = [sum(f32_live(t * F_BK, lens, T) for t in tiles)
                  for tiles in f32_ranges(K_, splits)]
        assert max(walked) <= -(-sum(walked) // len(walked)) + B, walked


def f32_live_first(j, lens, T):
    """gemm_f32.cuh::LiveRows::live_first: the frame at position j of the
    order "every live frame, then every other"."""
    live = int(sum(lens))
    at = j if j < live else j - live
    for b, n_live in enumerate(lens):
        n = n_live if j < live else T - n_live
        if at < n:
            return b * T + (at if j < live else n_live + at)
        at -= n
    return -1


def f32_emulate(A, Bm, K_, splits, walk=None, order=None, colsum=False):
    """ring_kernel on dense operands A [M, K] and B [K, N] (as the
    accessors read them, zeros outside), f64: each block's product over
    its live k-tiles; in the column tiles that order = (lens, T, n_from)
    names, its rows the live-first frames at its positions, a tile of dead
    frames skipping its product (writing zeros); with colsum, the first
    row tile's blocks sum their staged B tiles' columns. The epilogue
    writes each of a block's rows once. Returns (C, colsum)."""
    M, N = A.shape[0], Bm.shape[1]
    C = np.full((M, N), np.nan)
    cs = np.zeros(N)
    ranges = f32_ranges(K_, splits)
    for m0 in range(0, M, F_BM):
        for n0 in range(0, N, F_BN):
            pos = range(m0, min(m0 + F_BM, M))
            ordered = order is not None and n0 >= order[2]
            rows = [f32_live_first(j, order[0], order[1]) if ordered else j
                    for j in pos]
            dead = ordered and not any(m % order[1] < order[0][m // order[1]]
                                       for m in rows)
            acc = np.zeros((len(rows), min(F_BN, N - n0)))
            for tiles in ranges:
                for t in tiles:
                    if dead or (walk is not None
                                and not f32_live(t * F_BK, *walk)):
                        continue
                    k = slice(t * F_BK, (t + 1) * F_BK)
                    acc += A[rows, k] @ Bm[k, n0:n0 + F_BN]
                    if colsum and m0 == 0:
                        cs[n0:n0 + F_BN] += Bm[k, n0:n0 + F_BN].sum(0)
            assert np.isnan(C[rows, n0:n0 + F_BN]).all()  # written once
            C[rows, n0:n0 + F_BN] = acc
    return C, cs


@pytest.mark.parametrize("B,T", [(16, 398), (16, 199), (1, 1), (5, 37),
                                 (3, 19)])
def test_f32_live_first_order_is_a_permutation_live_frames_first(B, T):
    lens = _lens(B, T, seed=B + 2 * T)
    order = [f32_live_first(j, lens, T) for j in range(B * T)]
    assert sorted(order) == list(range(B * T))
    live = int(lens.sum())
    assert all(m % T < lens[m // T] for m in order[:live])
    assert not any(m % T < lens[m // T] for m in order[live:])
    assert order[:live] == sorted(order[:live])


@pytest.mark.parametrize("B,T,D,H,ones", [(3, 19, 12, 8, False),
                                          (5, 37, 33, 40, False),
                                          (2, 130, 20, 24, True),
                                          (1, 1, 16, 16, False),
                                          (4, 70, 136, 20, False),
                                          (3, 40, 150, 36, False)])
def test_f32_emulated_products_equal_the_plain_twin(B, T, D, H, ones):
    """dx (its dead row tiles skipped), dW_x with db, dW_h of both
    directions (their dead frame tiles skipped), each at its plan's splits
    and with none, against the plain twin in f64 on a dg that is 0 past
    lens (as the recurrence writes it)."""
    lens = _lens(B, T, seed=B + T + D, ones=ones)
    rng = np.random.RandomState(B * T + 1)
    live = np.arange(T)[None, :, None] < lens[:, None, None]
    x = rng.randn(B, T, D)
    y = rng.randn(B, T, 2 * H) * live
    dg = rng.randn(B, T, 8 * H) * live
    w_x = rng.randn(D, 8 * H)
    M = B * T
    g = dg.reshape(M, 8 * H)
    walk = (lens, T)
    t64 = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = K.bilstm_fused_bwd_products_plain(
        t64(x), t64(lens), t64(w_x), t64(y), t64(dg), torch.float32)
    zero = np.zeros((B, 1, H))
    h_prev = (np.concatenate([zero, y[:, :-1, :H]], 1),
              np.concatenate([y[:, 1:, H:], zero], 1))
    for plan in (True, False):
        s = (lambda *a: f32_splits(*a, SMS)) if plan else (lambda *a: 1)
        dx, _ = f32_emulate(g, w_x.T, 8 * H, s(-(-M // 2), D, 8 * H),
                            order=(lens, T, 0))
        dwx, db = f32_emulate(x.reshape(M, D).T, g, M, s(D, 8 * H, M),
                              walk=walk, colsum=True)
        dwh = [f32_emulate(h_prev[d].reshape(M, H).T,
                           g[:, d * 4 * H:(d + 1) * 4 * H], M,
                           s(2 * H, 4 * H, M), walk=walk)[0] for d in range(2)]
        got = (dx.reshape(B, T, D), dwx, db, dwh[0], dwh[1])
        for name, a, w in zip(NAMES, got, want):
            np.testing.assert_allclose(a, w.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name} plan={plan}")


@pytest.mark.parametrize("B,T,D,H,ones", [(3, 19, 12, 8, False),
                                          (5, 37, 33, 130, False),
                                          (8, 150, 64, 32, True),
                                          (16, 199, 40, 32, False)])
def test_f32_emulated_projection_equals_the_plain_twin(B, T, D, H, ones):
    """The projection's row tiles of dead frames skip the backward half's
    product and its epilogue writes bias + product, 0 in the backward
    half past lens: the plain twin's xg, f64."""
    lens = _lens(B, T, seed=B + T + D, ones=ones)
    rng = np.random.RandomState(B + D)
    x = rng.randn(B, T, D)
    w_x = rng.randn(D, 8 * H)
    b_x = rng.randn(8 * H)
    M = B * T
    prod, _ = f32_emulate(x.reshape(M, D), w_x, D, 1, order=(lens, T, 4 * H))
    xg = prod + b_x
    dead_row = np.arange(M) % T >= lens[np.arange(M) // T]
    xg[np.ix_(dead_row, np.arange(4 * H, 8 * H))] = 0.0
    t64 = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = K.bilstm_fused_proj_plain(t64(x), t64(lens), t64(w_x), t64(b_x),
                                     torch.float32)
    np.testing.assert_allclose(xg.reshape(B, T, 8 * H), want.numpy(),
                               rtol=1e-12, atol=1e-12)


def f32_load_map(outer):
    """load_tile: (thread, chunk j) -> (o, k, shared-memory offset) of the
    chunk's first float, the stage [kBK][128] (outer) or
    [128][kBK + kSkew]."""
    out = {}
    for tid in range(F_THREADS):
        for j in range(128 * F_BK // 4 // F_THREADS):
            e = tid + j * F_THREADS
            if outer:
                k, o = e // 32, e % 32 * 4
                off = k * 128 + o
            else:
                o, k = e // (F_BK // 4), e % (F_BK // 4) * 4
                off = o * (F_BK + F_SKEW) + k
            out[tid, j] = (o, k, off)
    return out


@pytest.mark.parametrize("outer", [True, False])
def test_f32_loads_cover_each_tile_element_once(outer):
    seen = {}
    for (tid, j), (o, k, off) in f32_load_map(outer).items():
        for i in range(4):  # four floats along the contiguous index
            elem = (o + i, k) if outer else (o, k + i)
            assert elem not in seen
            seen[elem] = off + i
    assert sorted(seen) == [(o, k) for o in range(128) for k in range(F_BK)]
    floats = F_BK * 128 if outer else 128 * (F_BK + F_SKEW)
    assert len(set(seen.values())) == len(seen)
    assert max(seen.values()) < floats
    for (o, k), off in seen.items():  # each operand's layout, as read
        assert off == (k * 128 + o if outer else o * (F_BK + F_SKEW) + k)
    # 16-byte copies land on 16-byte boundaries
    assert all(off % 4 == 0 for _, _, off in f32_load_map(outer).values())


def f32_row(tid, i, outer):
    """gemm_f32.cuh::row_of: row i < 8 of thread tid."""
    lane, base = tid % 32, tid // 32 // 2 * 32
    lr = lane // 8
    if outer:
        return base + (lr * 4 + i if i < 4 else 16 + lr * 4 + (i - 4))
    return base + lr + 4 * i


def f32_col(tid, j, outer):
    """gemm_f32.cuh::col_of: column j < 8 of thread tid."""
    lane, base = tid % 32, tid // 32 % 2 * 64
    lc = lane % 8
    if outer:
        return base + (lc * 4 + j if j < 4 else 32 + lc * 4 + (j - 4))
    return base + lc + 8 * j


@pytest.mark.parametrize("a_outer", [True, False])
@pytest.mark.parametrize("b_outer", [True, False])
def test_f32_thread_tiles_cover_the_block_tile_once(a_outer, b_outer):
    seen = np.zeros((F_BM, F_BN), int)
    for tid in range(F_THREADS):
        for i in range(8):
            for j in range(8):
                seen[f32_row(tid, i, a_outer), f32_col(tid, j, b_outer)] += 1
    assert (seen == 1).all()
    # the epilogue's four adjacent columns of an outer B: j and j + 1 .. 3
    for tid in range(F_THREADS):
        for g in range(2):
            assert [f32_col(tid, 4 * g + q, True) for q in range(4)] == list(
                range(f32_col(tid, 4 * g, True), f32_col(tid, 4 * g, True) + 4))


def _halves_conflict_free(addrs):
    """A warp's 8-byte shared loads (float offsets, one a lane): each half
    warp's distinct words fall in distinct pairs of banks."""
    for p in range(2):
        a = {addrs[lane] for lane in range(16 * p, 16 * p + 16)}
        banks = [b % 32 for off in a for b in (off, off + 1)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("operand", ["A", "B"])
def test_f32_both_along_k_reads_are_free_of_bank_conflicts(operand):
    """dx's product (A and B both contiguous along k) reads 2 k's a row or
    column, 8 bytes a lane."""
    P = F_BK + F_SKEW
    for warp in range(F_THREADS // 32):
        for kh in range(0, F_BK, 2):
            for idx in range(8):
                addrs = []
                for lane in range(32):
                    tid = warp * 32 + lane
                    at = (f32_row(tid, idx, False) if operand == "A"
                          else f32_col(tid, idx, False))
                    off = at * P + kh
                    assert off % 2 == 0
                    addrs.append(off)
                assert _halves_conflict_free(addrs), (operand, warp, kh, idx)


def _phases_conflict_free(addrs):
    """A warp's 16-byte shared loads (float offsets, one a lane): each
    phase of 8 lanes reads distinct addresses in distinct 16-byte bank
    groups, or one address (a broadcast)."""
    for p in range(4):
        a = {addrs[lane] for lane in range(8 * p, 8 * p + 8)}
        groups = {off // 4 % 8 for off in a}
        if len(groups) != len(a):
            return False
    return True


@pytest.mark.parametrize("pattern", ["outer A", "outer B", "k-contiguous A",
                                     "k-contiguous B"])
def test_f32_fragment_reads_are_free_of_bank_conflicts(pattern):
    P = F_BK + F_SKEW
    for warp in range(F_THREADS // 32):
        for kq in range(0, F_BK, 4):
            for idx in range(8):
                addrs = []
                for lane in range(32):
                    tid = warp * 32 + lane
                    kk, q = idx % 4, idx // 4  # a k of 4, a run of 4
                    if pattern == "outer A":  # a k row, the thread's rows
                        off = (kq + kk) * 128 + f32_row(tid, 4 * q, True)
                    elif pattern == "outer B":
                        off = (kq + kk) * 128 + f32_col(tid, 4 * q, True)
                    elif pattern == "k-contiguous A":  # row i, 4 k's
                        off = f32_row(tid, idx, False) * P + kq
                    else:  # column j of B stored [n][k], 4 k's
                        off = f32_col(tid, idx, False) * P + kq
                    assert off % 4 == 0
                    addrs.append(off)
                assert _phases_conflict_free(addrs), (pattern, warp, kq, idx)
