"""PyTorch port, K1-fwd's projection (xg = x . W_x + b, the backward half
masked past lens) on the CPU: what of it can run without the card.

- (a) The wrapper of the bf16 kernel, ``bilstm_fused_proj_kernel``,
  refuses CPU tensors, wrong dtypes and wrong shapes without launching;
  its plain twin ``bilstm_fused_proj_plain`` is the projection that
  ``bilstm_fused_plain`` forms, and matches the JAX package's; the CPU
  route of ``bilstm_fused`` still matches the JAX package's
  ``bilstm_fused`` (its Pallas kernel in interpret mode) at two layers'
  shapes, H=16, at ``tests/test_torch_bilstm.py``'s tolerances.
- (b) A NumPy emulation of the schedule of the bf16 kernel
  (``csrc/proj_sm90.cuh``: ``proj_kernel`` and ``launch_proj``), mirrored
  from the source with its constants read from it: the persistent tile
  walk, the TMA boxes with their out-of-bounds zeros, the consumers' reads
  of the swizzled f32 x tile into wgmma's A fragment, the epilogue's bias,
  masks (at M and N by the TMA store's clipping, on the backward half past
  lens) and round_xg, through the swizzled staging buffers. It shows that
  every element of xg is written exactly once and, summing the emulated
  boxes in f64, that xg equals the plain twin's; also that the A fragment
  covers each 64 x 16 slice once, that its 8-byte reads (and the
  epilogue's 8-byte writes) are free of bank conflicts, and that every box
  starts on a 16-byte boundary. At the flagship's layer shapes and at
  ragged ones.

The kernel itself runs only on the card (``tests/test_torch_cuda_bilstm.py``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops.pallas_lstm import bilstm_fused as jax_bilstm_fused
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                   "proj_sm90.cuh")
with open(SRC) as _f:
    TEXT = _f.read()


def _layer(B, T, D, H, seed, lens=None):
    rng = np.random.RandomState(seed)
    if lens is None:
        lens = rng.randint(1, T + 1, size=B).astype(np.int32)
        lens[0] = T
        lens[-1] = 1
    return {"x": rng.randn(B, T, D).astype(np.float32),
            "lens": np.asarray(lens, np.int32),
            "w_x": (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
            "b_x": (rng.randn(8 * H) * 0.1).astype(np.float32),
            "w_hf": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
            "w_hb": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)}


def _torch(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in a.values())


# ---------------------------------------------------------------------------
# (a) the wrapper, the plain twin, the CPU route against JAX
# ---------------------------------------------------------------------------


def test_projection_wrapper_refuses_cpu_tensors():
    x, lens, w_x, b_x, _, _ = _torch(_layer(3, 5, 4, 8, seed=0))
    n = K.bilstm_fused_proj_kernel.launches
    for cd in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="CUDA"):
            K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, cd)
    assert K.bilstm_fused_proj_kernel.launches == n


@pytest.mark.parametrize("what", ["x dtype", "lens dtype", "w_x shape",
                                  "b_x shape", "x rank", "w_x width",
                                  "compute dtype", "x layout"])
def test_projection_wrapper_refuses_wrong_dtypes_and_shapes(what):
    x, lens, w_x, b_x, _, _ = _torch(_layer(3, 5, 4, 8, seed=1))
    cd = torch.bfloat16
    if what == "x dtype":
        x = x.double()
    elif what == "lens dtype":
        lens = lens.long()
    elif what == "w_x shape":
        w_x = w_x[:3]
    elif what == "b_x shape":
        b_x = b_x[:-8]
    elif what == "x rank":
        x = x.reshape(15, 4)
    elif what == "w_x width":
        w_x = w_x[:, :60]
    elif what == "compute dtype":
        cd = torch.float16
    else:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    n = K.bilstm_fused_proj_kernel.launches
    with pytest.raises(ValueError) as e:
        K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, cd)
    assert "CUDA" not in str(e.value)  # refused for what it is, not where
    assert K.bilstm_fused_proj_kernel.launches == n


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_xg", [False, True])
def test_plain_twin_is_the_projection_of_the_plain_layer(cd, round_xg):
    x, lens, w_x, b_x, _, _ = _torch(_layer(4, 9, 6, 8, seed=2))
    calls = K.bilstm_fused_proj_plain.calls
    got = K.bilstm_fused_proj_plain(x, lens, w_x, b_x, cd, round_xg)
    assert K.bilstm_fused_proj_plain.calls == calls + 1
    want = torch.cat(K._project(x, lens, w_x, b_x, cd, round_xg), -1)
    assert torch.equal(got, want)
    past = torch.arange(9)[None, :] >= lens[:, None]
    assert not got[..., 32:][past].any() and got[..., :32][past].any()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_twin_matches_the_jax_projection(cd):
    """The projection of the JAX kernel (``_v2_fwd_kernel``: the operands
    in the compute dtype, f32 sums, the bias, the backward half masked)."""
    a = _layer(3, 11, 12, 16, seed=3)
    cdt = jnp.dtype(cd)
    x, w_x, b_x = (jnp.asarray(a[k]) for k in ("x", "w_x", "b_x"))
    xg = jnp.dot(x.astype(cdt), w_x.astype(cdt),
                 preferred_element_type=jnp.float32) + b_x
    valid = np.arange(11)[None, :, None] < a["lens"][:, None, None]
    want = np.asarray(xg).copy()
    want[..., 64:] *= valid
    got = K.bilstm_fused_proj_plain(*_torch(a)[:4], getattr(torch, cd))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_cpu_route_matches_jax_bilstm_fused(layer, cd):
    """Two layers' shapes of a small pyramid, H=16: layer 0 over features
    (D=12), layer 1 over the first layer's output (D=2H); the JAX kernel
    in interpret mode. Tolerances of tests/test_torch_bilstm.py."""
    H = 16
    B, T, D = (5, 23, 12) if layer == 0 else (5, 12, 2 * H)
    a = _layer(B, T, D, H, seed=30 + layer)
    ref = np.asarray(jax_bilstm_fused(*(jnp.asarray(v) for v in a.values()),
                                      jnp.dtype(cd), 8))
    got = K.bilstm_fused(*_torch(a), compute_dtype=getattr(torch, cd))
    tol = (dict(rtol=1e-5, atol=1e-6) if cd == "float32"
           else dict(rtol=0.0, atol=1e-2))
    np.testing.assert_allclose(got.numpy(), ref, **tol)


@pytest.mark.parametrize("D", [1, 4, 33, 80, 1280])
def test_operands_as_the_kernel_reads_them(D):
    """x's rows padded to 4 floats (zeros), scratch for W_x's bf16 copy
    as W_x^T with rows of ldw, D rounded up to 8; f32 takes both as they
    are."""
    x = torch.randn(2, 3, D)
    w_x = torch.randn(D, 16)
    xp, ldx, wt16, ldw = K._proj_operands(x, w_x, torch.bfloat16)
    assert ldx % 4 == 0 and ldx - D < 4 and xp.shape == (2, 3, ldx)
    assert torch.equal(xp[..., :D], x) and not xp[..., D:].any()
    assert ldw % 8 == 0 and ldw - D < 8 and wt16.shape == (16, ldw)
    assert wt16.dtype == torch.bfloat16 and wt16.is_contiguous()
    assert (xp is x) == (D % 4 == 0)
    assert K._proj_operands(x, w_x, torch.float32) == (x, D, None, D)


# ---------------------------------------------------------------------------
# (b) the schedule of the bf16 kernel, emulated
# ---------------------------------------------------------------------------


def _constants():
    got = {name: int(v) for name, v in
           re.findall(r"constexpr int (k\w+) = (\d+);", TEXT)}
    for name in ("kBM", "kBN", "kBK", "kBox", "kOutCols", "kStages",
                 "kThreads"):
        assert name in got, name
    return got


C = _constants()
BM, BN, BK, BOX, OUT = C["kBM"], C["kBN"], C["kBK"], C["kBox"], C["kOutCols"]
SMS = 132  # the H100's

# The lines of the source that the emulation mirrors: each must be there
# as it is written, so that an edit of the kernel fails here until the
# emulation follows it.
MIRRORED = (
    "__device__ __forceinline__ int row_of(int g) { return (2 * g) % 8 + g / 4; }",
    "  const int row0 = 64 * wg + 16 * warp + rg;",
    "      off[jj][s] = (((4 * jj + 2 * s + (q >> 1)) ^ rg) << 4) + 8 * (q & 1);",
    "  const uint8_t* box = stage + (j / 2) * kABoxBytes + row0 * 128;",
    "    s.v[i] = *reinterpret_cast<const float2*>(box + (i & 1) * 8 * 128\n"
    "                                              + off[j & 1][i >> 1]);",
    "  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s.v[i].x, s.v[i].y);",
    "        for (int b = 0; b < kABoxes; ++b) {\n"
    "          tma_load_2d(s + b * kABoxBytes, &x_map, full + st, k * kBK + b * kBox, m0);",
    "        tma_load_2d(s + kABoxes * kABoxBytes, &w_map, full + st, k * kBK, n0);",
    "constexpr int kABoxes = kBK / kBox;             // x boxes a stage",
    "      const uint64_t db = b_desc(s + kABoxes * kABoxBytes);",
    "          const int r = 16 * warp + rg + 8 * h;  // the buffer's row",
    "          *reinterpret_cast<float2*>(buf + r * 128\n"
    "              + (((2 * jj + (q >> 1)) ^ rg) << 4) + 8 * (q & 1)) =",
    "        tma_store_2d(&out_map, buf, n0 + c * kOutCols, m0 + 64 * wg);",
    "    tile[i][tx] = d < D && n < N ? w[(size_t)d * N + n] : 0.0f;",
    "    if (n < N && d < ldw) wt[(size_t)n * ldw + d] = __float2bfloat16_rn(tile[tx][i]);",
    "          if (n >= half && dead[h]) v0 = v1 = 0.0f;",
    "          float v0 = acc[4 * j + 2 * h] + bias[jj].x;",
    "    load_bias(bias, args, n0 + 2 * q);",
    "      if (c + 1 < kBN / kOutCols) load_bias(next, args, n0 + (c + 1) * kOutCols + 2 * q);",
    "    bias[jj] = n + 8 * jj < args.N\n"
    "        ? __ldg(reinterpret_cast<const float2*>(args.bias + n + 8 * jj))\n"
    "        : make_float2(0.0f, 0.0f);",
    "        dead[h] = m - b * args.T >= args.lens[b];",
    "      const int m0 = t / args.ntiles * kBM, n0 = t % args.ntiles * kBN;",
    "    for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {",
    "  if (!make_map(&x_map, x, false, D, M, ldx, kBox, kBM) ||\n"
    "      !make_map(&w_map, wt16, true, D, N, ldw, kBK, kBN) ||\n"
    "      !make_map(&out_map, xg, false, N, M, N, kOutCols, 64)) {",
)


def wt_copy(w_x, ldw):
    """wt_kernel: bf16(W_x)^T [N][ldw], tile by tile (32 x 32 through
    shared memory, as the source), 0 at d >= D; NaN where no tile writes."""
    D, N = w_x.shape
    tile = C["kWtTile"]
    wt = np.full((N, ldw), np.nan)
    for n0 in range(0, N, tile):
        for d0 in range(0, ldw, tile):
            blk = box(w_x, n0, d0, tile, tile)  # [d][n], 0 past D and N
            for i in range(tile):  # the writes: row n0 + i, d along tx
                n = n0 + i
                d = d0 + np.arange(tile)
                keep = (n < N) & (d < ldw)
                if n < N:
                    assert np.isnan(wt[n, d[keep]]).all()
                    wt[n, d[keep]] = bf16(blk[:, i])[keep]
    return wt


@pytest.mark.parametrize("D,N", [(80, 2560), (1280, 2560), (33, 1040),
                                 (12, 64), (70, 288)])
def test_w_x_copy_is_the_rounded_transpose_written_once(D, N):
    rng = np.random.RandomState(D)
    w_x = rng.randn(D, N).astype(np.float32)
    ldw = K._proj_operands(torch.zeros(1, 1, D), torch.zeros(D, N),
                           torch.bfloat16)[3]
    wt = wt_copy(w_x, ldw)
    assert not np.isnan(wt).any()
    np.testing.assert_array_equal(wt[:, :D], bf16(w_x.T))
    assert not wt[:, D:].any()


def test_the_emulation_mirrors_the_source():
    for line in MIRRORED:
        assert TEXT.count(line) >= 1, line


def row_of(g):
    return (2 * g) % 8 + g // 4


def swizzled(row, col_byte):
    """The byte a TMA box in the 128-byte swizzle (rows of 128 bytes) keeps
    (row, col_byte) at: the 16-byte chunk c of row r at c ^ (r % 8)."""
    return row * 128 + (col_byte ^ ((row & 7) << 4))


def unswizzled(addr):
    row = addr // 128
    return row, (addr % 128) ^ ((row & 7) << 4)


def threads():
    """(wg, warp, lane, g, q) of each consumer thread."""
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                yield wg, warp, lane, lane >> 2, lane & 3


def read_addrs(wg, warp, g, q, j):
    """The 4 byte offsets into the stage's x boxes that thread (wg, warp,
    g, q) reads for k16 slice j (read_slice): register i's float2."""
    rg = row_of(g)
    row0 = 64 * wg + 16 * warp + rg
    off = [[(((4 * jj + 2 * s + (q >> 1)) ^ rg) << 4) + 8 * (q & 1)
            for s in range(2)] for jj in range(2)]
    box = (j // 2) * BM * BOX * 4 + row0 * 128
    return [box + (i & 1) * 8 * 128 + off[j & 1][i >> 1] for i in range(4)]


def a_fragment_rows(j):
    """For k16 slice j of a stage, per consumer warpgroup: frag_row ->
    the x tile's row that wgmma's A row frag_row holds, from the read
    addresses through the TMA's swizzle and the PTX fragment layout
    (register i of thread l of warp w: A rows 16w + l/4 + 8 (i % 2), k
    2(l % 4) + 8 (i / 2) + e, e = 0, 1). Asserts the k index is the one
    the layout names, the slice's."""
    rows = np.full((2, 64), -1)
    for wg, warp, lane, g, q in threads():
        for i, addr in enumerate(read_addrs(wg, warp, g, q, j)):
            box, inbox = divmod(addr, BM * BOX * 4)
            assert box == j // 2
            r, cb = unswizzled(inbox)
            for e in range(2):
                k = box * BOX + (cb + 4 * e) // 4  # the stage's k
                fr, fk = 16 * warp + g + 8 * (i & 1), 2 * q + 8 * (i >> 1) + e
                assert k == 16 * j + fk, (j, wg, lane, i, e)
                assert rows[wg, fr] in (-1, r)
                rows[wg, fr] = r
    return rows


@pytest.mark.parametrize("j", range(BK // 16))
def test_a_fragment_covers_each_64_by_16_slice_once(j):
    rows = a_fragment_rows(j)
    for wg in range(2):
        # every row of the consumer's 64 rows once, within its 8-row group
        assert sorted(rows[wg]) == list(range(64 * wg, 64 * wg + 64))
        assert all(rows[wg, fr] // 8 == (64 * wg + fr) // 8 for fr in range(64))
    # each (row, k) element of the slice read by exactly one thread once
    seen = {}
    for wg, warp, lane, g, q in threads():
        for i, addr in enumerate(read_addrs(wg, warp, g, q, j)):
            for e in range(2):
                key = addr + 4 * e
                assert key not in seen
                seen[key] = (wg, warp, lane, i, e)
    assert len(seen) == 2 * 64 * 16


def _conflict_free(addrs):
    """16 8-byte accesses (a half-warp's share of a warp's 8-byte access)
    hit all 32 banks once each."""
    banks = [(a // 4 + h) % 32 for a in addrs for h in range(2)]
    return len(set(banks)) == 32


@pytest.mark.parametrize("j", range(BK // 16))
def test_fragment_reads_are_free_of_bank_conflicts(j):
    for wg in range(2):
        for warp in range(4):
            for i in range(4):
                for half in range(2):
                    addrs = [read_addrs(wg, warp, lane >> 2, lane & 3, j)[i]
                             for lane in range(16 * half, 16 * half + 16)]
                    assert _conflict_free(addrs), (wg, warp, i, half)
    # and fragment row g in place of row_of(g) would conflict: the reason
    # for the permutation
    def plain_addr(lane, i):
        g, q = lane >> 2, lane & 3
        c = 4 * (j & 1) + 2 * (i >> 1) + (q >> 1)
        return g * 128 + ((c ^ g) << 4) + 8 * (q & 1)
    assert not _conflict_free([plain_addr(lane, 0) for lane in range(16)])


def epilogue_addrs(warp, g, q, h, jj):
    """Thread (warp, g, q)'s staging-buffer byte offset for its value
    pair (row half h, column group jj of a 32-column store box)."""
    rg = row_of(g)
    r = 16 * warp + rg + 8 * h
    return r * 128 + (((2 * jj + (q >> 1)) ^ rg) << 4) + 8 * (q & 1)


def test_epilogue_staging_covers_each_box_once_without_bank_conflicts():
    seen = set()
    for warp in range(4):
        for h in range(2):
            for jj in range(OUT // 8):
                addrs = []
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    a = epilogue_addrs(warp, g, q, h, jj)
                    row, cb = unswizzled(a)
                    # accumulator (16w + g + 8h, 8jj + 2q + e) of the chunk
                    assert row == 16 * warp + row_of(g) + 8 * h
                    assert cb // 4 == 8 * jj + 2 * q
                    seen.update((row, cb // 4 + e) for e in range(2))
                    addrs.append(a)
                assert _conflict_free(addrs[:16]) and _conflict_free(addrs[16:])
    assert seen == {(r, c) for r in range(64) for c in range(OUT)}


def plan(M, N, D):
    """launch_proj's grid: (steps, ntiles, tiles, blocks)."""
    steps = -(-D // BK)
    ntiles = -(-N // BN)
    tiles = -(-M // BM) * ntiles
    return steps, ntiles, tiles, min(tiles, SMS)


# The flagship's layers at the 4.0 s bucket (B, T, D, H) and at bench.py's
# shape, then ragged ones: B=1 and T=1, D=33 with H=130 (8H not a multiple
# of the tile, x's rows padded), H=256, tiny widths, M just past a tile.
FLAGSHIP = [(96, 398, 80, 320), (96, 199, 1280, 320), (96, 100, 1280, 320),
            (96, 1278, 80, 320), (96, 639, 1280, 320), (96, 320, 1280, 320)]
RAGGED = [(1, 1, 80, 320), (5, 37, 33, 130), (16, 199, 512, 256),
          (3, 19, 12, 8), (1, 129, 70, 36), (2, 64, 16, 16)]


@pytest.mark.parametrize("B,T,D,H", FLAGSHIP + RAGGED)
def test_every_element_is_written_exactly_once(B, T, D, H):
    """The persistent walk takes every tile once; a tile's two consumers
    store 8 boxes of 64 rows x 32 columns each (each box's staging
    written once, above); the TMA clips them at M and N. So the clipped
    boxes must partition [0, M) x [0, N)."""
    M, N = B * T, 8 * H
    steps, ntiles, tiles, blocks = plan(M, N, D)
    walks = [list(range(b, tiles, blocks)) for b in range(blocks)]
    assert sorted(t for w in walks for t in w) == list(range(tiles))
    row_cover = np.zeros(M, np.int64)
    col_cover = np.zeros(N, np.int64)
    origins = set()
    for t in range(tiles):
        m0, n0 = t // ntiles * BM, t % ntiles * BN
        for wg in range(2):
            for c in range(BN // OUT):
                origins.add((m0 + 64 * wg, n0 + c * OUT))
    rows = sorted({r for r, _ in origins})
    cols = sorted({c for _, c in origins})
    assert len(origins) == len(rows) * len(cols)  # a grid of boxes
    for r in rows:
        row_cover[r:min(r + 64, M)] += 1
    for c in cols:
        col_cover[c:min(c + OUT, N)] += 1
    assert (row_cover == 1).all() and (col_cover == 1).all()
    # the k steps cover D, the last one's columns past D zero-filled
    assert steps * BK >= D > (steps - 1) * BK


def box(a, c0, c1, rows, cols):
    """A TMA box of a 2-D map [d1][d0] = a: rows c1 .. c1 + rows, columns
    c0 .. c0 + cols, 0 out of bounds."""
    out = np.zeros((rows, cols), a.dtype)
    R, W = a.shape
    r0, r1 = max(c1, 0), min(c1 + rows, R)
    k0, k1 = max(c0, 0), min(c0 + cols, W)
    if r0 < r1 and k0 < k1:
        out[r0 - c1:r1 - c1, k0 - c0:k1 - c0] = a[r0:r1, k0:k1]
    return out


def bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).to(torch.float64).numpy()


def emulate(x, lens, w_x, b_x, T, round_xg):
    """xg from the kernel's schedule in f64: per tile, per consumer, the
    stage boxes as the TMA writes them (maps of D columns: zeros past D,
    M and N), the fragment rows of each slice (a_fragment_rows), the
    bf16 rounding of x and W_x, the f64 products, the epilogue (bias,
    backward half past lens, round_xg) into the staging buffer's rows
    (epilogue_addrs) and the clipped stores."""
    B, _, D = x.shape
    M, N = B * T, w_x.shape[1]
    xm = x.reshape(M, D)
    xp, ldx, _, ldw = K._proj_operands(torch.from_numpy(x),
                                       torch.from_numpy(w_x), torch.bfloat16)
    x_rows = xp.reshape(M, ldx).numpy()[:, :D]  # the map's D columns
    assert np.array_equal(x_rows, xm)
    wt = wt_copy(w_x, ldw)[:, :D]  # W_x^T, the map's D columns
    steps, ntiles, tiles, _ = plan(M, N, D)
    frag = [a_fragment_rows(j) for j in range(BK // 16)]
    # the staging buffer's row of accumulator row 16w + g + 8h
    out_row = np.zeros(64, int)
    for warp in range(4):
        for g in range(8):
            for h in range(2):
                out_row[16 * warp + g + 8 * h] = unswizzled(
                    epilogue_addrs(warp, g, 0, h, 0))[0]
    out = np.full((M, N), np.nan)
    for t in range(tiles):
        m0, n0 = t // ntiles * BM, t % ntiles * BN
        acc = np.zeros((2, 64, BN))
        for k in range(steps):
            a_tile = np.concatenate([box(x_rows, k * BK + b * BOX, m0, BM, BOX)
                                     for b in range(BK // BOX)], 1)
            b_tile = box(wt, k * BK, n0, BN, BK)  # [n][k], already bf16
            for j in range(BK // 16):
                for wg in range(2):
                    a = bf16(a_tile[frag[j][wg], 16 * j:16 * j + 16])
                    acc[wg] += a @ b_tile[:, 16 * j:16 * j + 16].T
        for wg in range(2):
            # the rows whose lens the epilogue reads: row0 + 8h, as read
            rows = frag[0][wg]
            assert all(np.array_equal(f[wg], rows) for f in frag)
            for c in range(BN // OUT):
                cols = n0 + c * OUT + np.arange(OUT)
                bias = np.where(cols < N, b_x[np.minimum(cols, N - 1)], 0.0)
                stage = np.zeros((64, OUT))
                m = m0 + rows
                dead = np.zeros(64, bool)
                inside = m < M
                b = m[inside] // T
                dead[inside] = m[inside] - b * T >= lens[b]
                v = acc[wg][:, c * OUT:(c + 1) * OUT] + bias
                v[dead[:, None] & (cols >= N // 2)[None, :]] = 0.0
                if round_xg:
                    v = bf16(v)
                stage[out_row] = v
                r0, c0 = m0 + 64 * wg, n0 + c * OUT
                r1, c1 = min(r0 + 64, M), min(c0 + OUT, N)
                if r0 < r1 and c0 < c1:
                    assert np.isnan(out[r0:r1, c0:c1]).all()
                    out[r0:r1, c0:c1] = stage[:r1 - r0, :c1 - c0]
    return out.reshape(B, T, N)


@pytest.mark.parametrize("round_xg", [False, True])
@pytest.mark.parametrize("B,T,D,H,ones", [
    (2, 100, 80, 320, False), (2, 50, 1280, 320, False),
    (1, 1, 80, 320, False), (3, 37, 33, 130, False), (2, 70, 512, 256, True),
    (3, 19, 12, 8, False), (1, 129, 70, 36, False)])
def test_emulated_projection_equals_the_plain_twin(B, T, D, H, ones, round_xg):
    """The flagship's widths (B cut to 2, T to the layer's or less) and
    ragged shapes: the emulation in f64 against the plain twin in f64
    (operands rounded to bf16 alike, sums in f64)."""
    a = _layer(B, T, D, H, seed=B + T + D,
               lens=np.ones(B, np.int32) if ones else None)
    got = emulate(a["x"], a["lens"], a["w_x"], a["b_x"].astype(np.float64), T,
                  round_xg)
    t64 = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    want = K.bilstm_fused_proj_plain(
        t64(a["x"].astype(np.float64)), t64(a["lens"]),
        t64(a["w_x"].astype(np.float64)), t64(a["b_x"].astype(np.float64)),
        torch.bfloat16, round_xg).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,T,D,H", FLAGSHIP + RAGGED)
def test_every_box_starts_on_a_16_byte_boundary(B, T, D, H):
    """The TMA takes a box only where its start along a row, and every row
    stride, is a multiple of 16 bytes: x's rows (f32) as the wrapper pads
    them, W_x^T's (bf16) rows of ldw, xg's (f32) rows of 8H."""
    M, N = B * T, 8 * H
    x = torch.zeros(1, 1, D)
    _, ldx, _, ldw = K._proj_operands(x, torch.zeros(D, N), torch.bfloat16)
    assert (4 * ldx) % 16 == 0 and (2 * ldw) % 16 == 0 and (4 * N) % 16 == 0
    steps, ntiles, _, _ = plan(M, N, D)
    for k in range(steps):
        assert (4 * k * BK) % 16 == 0 and (4 * (k * BK + BOX)) % 16 == 0
        assert (2 * k * BK) % 16 == 0
    for n0 in range(0, ntiles * BN, OUT):
        assert (4 * n0) % 16 == 0
    # and each box's rows are whole 128-byte swizzle rows
    assert 4 * BOX == 128 and 2 * BK == 128 and 4 * OUT == 128


# ---------------------------------------------------------------------------
# the probes' build variants
# ---------------------------------------------------------------------------


def _variants():
    from gluon_e2e_asr_tpu_torch.tools import k1b_probe, k1f_probe

    for name, sets in (("bilstm_fwd", (k1f_probe.CUTS, k1f_probe.PROJ_WMMA,
                                       k1f_probe.PROJ_CUTS)),
                       ("bilstm_bwd", (k1b_probe.CUTS, k1b_probe.PRODUCTS_WMMA,
                                       k1b_probe.PRODUCTS_CUTS))):
        for cuts in sets:
            for cut, pairs in cuts.items():
                yield name, cut, pairs


@pytest.mark.parametrize("name,cut,pairs", list(_variants()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_every_probe_variant_edits_one_place(name, cut, pairs):
    """tools/k1b_probe.py::build_cuts edits, for each (old, new) of a
    variant, the one place in csrc/<name>.cu and the csrc/ headers where
    old occurs: it must occur there exactly once (a text that sits in two
    headers would edit the wrong one)."""
    src = os.path.dirname(SRC)
    files = [f"{name}.cu"] + sorted(f for f in os.listdir(src)
                                    if f.endswith(".cuh"))
    texts = {}
    for f in files:
        with open(os.path.join(src, f)) as fh:
            texts[f] = fh.read()
    for old, new in pairs:
        assert sum(t.count(old) for t in texts.values()) == 1, (cut, old)
        assert old != new
