"""PyTorch port: a training step on the card is a function of its inputs.

What the card's bit-for-bit reproducibility rests on, checked on the CPU:

(a) the split plans of K1-bwd's products, modelled in Python at every
    config's shapes (the milestones, both flagships at the 4.0 s bucket
    and at bench.py's shape, vgg_blstm's D = 2560, ls100's buckets from
    B=148 down to B=32 at T=1836): ``csrc/bilstm_bwd.cu::f32_plan`` for
    ``ring_kernel`` (f32) and ``csrc/gemm_sm90.cuh::wgrad_workspace`` for
    ``wgrad_kernel`` (bf16). Which k-tiles (f32) or units (bf16) each split
    takes, that every live one lands in exactly one split's part, that
    every element of every part is stored by exactly one block (zeros
    where its split met no live frame), and the workspace's layout and
    bytes; and ``csrc/split_sum.cuh``'s sum in the order 0..S-1, emulated
    in float32: the same bits in whatever order the blocks finish, where
    an atomic sum of the same parts is not;
(b) the library sites' deterministic forms: the CTC posterior and the
    embedding gradient as one-hot products against the scatters they
    replace and against JAX (the tolerances of tests/test_torch_ctc.py:
    only the order of f32 sums differs); the stacked decoder's embedding
    lookup; VGG2L's convolution backward under cuDNN's deterministic
    algorithms;
(c) a static check over ``gluon_e2e_asr_tpu_torch/csrc/``: every float
    atomic lies in an allow-list (the tiled products' ``AtomicAdd`` and
    ``colsum_kernel``, which only the build variants ``K1_F32_TILED 0``
    and ``K1B_WGMMA_PRODUCTS 0`` compile, and the integer cycle counters
    of ``FE_TIMING``), and the default build, preprocessed, holds none
    but that unused epilogue.

The card's own checks: ``tests/test_torch_cuda_repro.py`` and
``chip_smoke.py``'s phases 3 (three launches of each kernel), 6c (resume)
and 6e (two runs of each training form, and a step under
``torch.use_deterministic_algorithms(True)``).
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
from gluon_e2e_asr_tpu_torch.models.encoder import Conv3x3
from gluon_e2e_asr_tpu_torch.ops import ctc as C
from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD
from gluon_e2e_asr_tpu_torch.ops.onehot import embed, rows_sum
from test_torch_bilstm_products import (
    C as SM90, SMS, f32_live, f32_ranges, f32_splits, wgrad_block, wgrad_jobs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CSRC = os.path.join(REPO, "gluon_e2e_asr_tpu_torch", "csrc")
TINY = os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")
PRODUCERS = SM90["kProducers"]  # wgrad_kernel's producer warpgroups


def _slice(n):
    """split_sum.cuh::slice: n floats rounded up to a multiple of 4."""
    return -(-n // 4) * 4


# ---------------------------------------------------------------------------
# (a) the split plans at every config's shapes
# ---------------------------------------------------------------------------


def _layers(path, seconds, B=None):
    config = load_config(os.path.join(REPO, "configs", path))
    fc = config.frontend
    T = num_frames(int(seconds * fc.sample_rate), fc.win_length, fc.hop_length)
    B = B or config.data.batch_size
    H = config.model.enc_hidden
    return [(f"{path} {seconds} s B={B} layer {layer}", B, T_, D, H)
            for layer, T_, D in chip_smoke.layer_shapes(config, T)]


def _shapes():
    """(name, B, T, D, H) of every K1 layer the configs train."""
    out = _layers("milestone1_bilstm_ctc.yaml", 4.0)
    for path in ("english_flagship.yaml", "flagship_bf16.yaml"):
        out += _layers(path, 4.0) + _layers(path, chip_smoke.BENCH_SEC)
    name, B, H, (_, T, D) = chip_smoke.vgg_case()
    out.append((f"{name} layer 0", B, T, D, H))
    for B in (148, 74, 49, 32):  # ls100_shape's dynamic batches, at T=1836
        out += _layers("ls100_shape.yaml", 18.38, B)
    return out


SHAPES = _shapes()
IDS = [s[0] for s in SHAPES]


def _lens(B, T, kind):
    rng = np.random.RandomState(B * 7 + T)
    lens = {"full": np.full(B, T), "ragged": rng.randint(1, T + 1, size=B),
            "short": rng.randint(1, max(T // 8, 1) + 1, size=B)}[kind]
    lens[0] = T if kind != "short" else lens[0]
    return lens.astype(np.int32)


def f32_plan(B, T, D, H, with_x=True):
    """csrc/bilstm_bwd.cu::f32_plan: the splits of dx (its blocks past the
    live frames exit at once, so it plans for half its rows), of dW_x with
    db and of both dW_h (one launch, split for their tiles together), and
    the workspace: dx's sdx - 1 slices, dW_x's swx - 1, db's 2 swx partial
    rows (ring_kernel's two halves of 128 threads a split), then each
    direction's swh - 1."""
    M, N8, N4 = B * T, 8 * H, 4 * H
    p = {"sdx": 1, "swx": 1, "swh": f32_splits(2 * H, N4, M, SMS)}
    if with_x:
        p["sdx"] = f32_splits(-(-M // 2), D, N8, SMS)
        p["swx"] = f32_splits(D, N8, M, SMS)
    p["slices"] = {"dx": _slice(M * D), "dw_x": _slice(D * N8), "db": N8,
                   "dw_h": _slice(H * N4)}
    s = p["slices"]
    p["floats"] = ((p["sdx"] - 1) * s["dx"] + (p["swx"] - 1) * s["dw_x"]
                   + 2 * p["swx"] * s["db"] if with_x else 0) \
        + 2 * (p["swh"] - 1) * s["dw_h"]
    return p


def f32_layout(B, T, D, H):
    """The workspace regions f32_products carves, in order: (name, first
    float, floats)."""
    p, at, out = f32_plan(B, T, D, H), 0, []
    s = p["slices"]
    for name, n in (("dx", (p["sdx"] - 1) * s["dx"]),
                    ("dw_x", (p["swx"] - 1) * s["dw_x"]),
                    ("db", 2 * p["swx"] * s["db"]),
                    ("dw_hf", (p["swh"] - 1) * s["dw_h"]),
                    ("dw_hb", (p["swh"] - 1) * s["dw_h"])):
        out.append((name, at, n))
        at += n
    assert at == p["floats"]
    return out


def bf16_plan(B, T, D, H, with_x=True):
    """csrc/gemm_sm90.cuh::wgrad_workspace: the splits of the unit list and
    the workspace: each job's S - 1 slices, then db's kProducers * S
    partial rows of 8H."""
    jobs, S, blocks = wgrad_jobs(B, T, D, H, with_x)
    floats = sum((S - 1) * _slice(j[1] * j[2]) for j in jobs)
    if with_x:
        floats += PRODUCERS * S * 8 * H
    return {"jobs": jobs, "splits": S, "tiles": blocks, "floats": floats}


@pytest.mark.parametrize("kind", ["full", "ragged", "short"])
@pytest.mark.parametrize("name,B,T,D,H", SHAPES, ids=IDS)
def test_f32_every_live_k_tile_lands_in_one_part(name, B, T, D, H, kind):
    """ring_kernel: split s of S takes the k-tiles s, s + S, ...; for each
    product every k-tile it walks (the weight gradients: the live ones)
    lies in exactly one split, the splits are 0..S-1, and split s's part
    goes to the output (s = 0) or to its own workspace slice."""
    lens = _lens(B, T, kind)
    M = B * T
    p = f32_plan(B, T, D, H)
    for product, S, depth, walk in (("dx", p["sdx"], 8 * H, False),
                                    ("dw_x", p["swx"], M, True),
                                    ("dw_h", p["swh"], M, True)):
        ranges = f32_ranges(depth, S)
        assert len(ranges) == S  # every split of the plan launches
        owner = {}
        for s, tiles in enumerate(ranges):
            for t in tiles:
                if walk and not f32_live(t * 16, lens, T):
                    continue
                assert t not in owner, (product, t)
                owner[t] = s
        ktiles = -(-depth // 16)
        want = [t for t in range(ktiles)
                if not walk or f32_live(t * 16, lens, T)]
        assert sorted(owner) == want, product
        assert set(owner.values()) <= set(range(S))
        # each split walks its tiles in increasing order: a fixed order
        for tiles in ranges:
            assert list(tiles) == sorted(tiles)
    regions = f32_layout(B, T, D, H)
    for (_, a, n), (_, b, _) in zip(regions, regions[1:]):
        assert a + n == b and a % 4 == 0  # disjoint, 16-byte aligned


@pytest.mark.parametrize("name,B,T,D,H", SHAPES, ids=IDS)
def test_bf16_every_live_unit_and_part_element_written_once(name, B, T, D, H):
    """wgrad_kernel: the unit list split into S contiguous ranges in order
    0..S-1, every live unit in exactly one; the persistent blocks' walk
    visits every (job, tile, split) once, so every element of every part
    (the output for split 0, slice s - 1 of the job's workspace else) is
    stored once, zeros where the split's range holds no live unit; db's
    partial rows once each, by the producers where the tile has a live
    unit and by the consumers where it has none."""
    lens = _lens(B, T, "ragged")
    plan = bf16_plan(B, T, D, H)
    jobs, S = plan["jobs"], plan["splits"]
    U = -(-T // 64)
    units = B * U
    ranges = [(s * units // S, (s + 1) * units // S) for s in range(S)]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    stored = {}
    db_rows = np.zeros((S, PRODUCERS, 8 * H), int)
    for bid in range(plan["tiles"]):
        job, m0, n0, begin, end = wgrad_block(bid, jobs, S, B, T)
        split = ranges.index((begin, end))
        key = (job[0], m0, n0, split)
        assert key not in stored
        live = [u for u in range(begin, end) if (u % U) * 64 < lens[u // U]]
        stored[key] = len(live)
        if job[0] == "dw_x" and m0 == 0:
            n = slice(n0, min(n0 + 128, 8 * H))
            db_rows[split, :, n] += 1  # producers (live) or consumers (none)
    for j in jobs:
        for split in range(S):
            for m0 in range(0, j[1], 128):
                for n0 in range(0, j[2], 128):
                    assert (j[0], m0, n0, split) in stored
    assert (db_rows == 1).all()
    # the parts of the workspace: each job's S - 1 slices, then db's rows
    at = 0
    for j in jobs:
        at += (S - 1) * _slice(j[1] * j[2])
        assert at % 4 == 0
    assert at + PRODUCERS * S * 8 * H == plan["floats"]


def test_workspace_bytes_at_the_configs_shapes():
    """The workspace a call takes, pinned at the shapes PERF.md names (the
    H100's 132 SMs): the flagship's layer 1 in bf16 (2 splits: a slice of
    dW_x and of each dW_h, and 2 x 2 db rows) and the milestones' three f32
    layers."""
    assert bf16_plan(96, 199, 1280, 320)["splits"] == 2
    assert 4 * bf16_plan(96, 199, 1280, 320)["floats"] == 4 * (
        1280 * 2560 + 2 * 320 * 1280 + 2 * 2 * 2560) == 16_424_960
    got = [f32_plan(16, T, D, 256) for T, D in ((398, 80), (199, 1024),
                                                (100, 1024))]
    assert [(p["sdx"], p["swx"], p["swh"]) for p in got] == [
        (10, 16, 8), (2, 2, 8), (4, 2, 8)]
    mb = [4 * p["floats"] / 1e6 for p in got]
    assert [round(x, 1) for x in mb] == [43.1, 36.1, 42.8]
    # K7-bwd's dW_h alone (no x): both directions' slices only
    assert f32_plan(96, 398, 0, 320, with_x=False)["floats"] == \
        2 * (f32_plan(96, 398, 80, 320)["swh"] - 1) * 320 * 1280


def _split_sum(out0, parts):
    """split_sum_kernel: ((p0 + p1) + p2) + ... in float32, p0 in out."""
    v = out0.copy()
    for p in parts:
        v = (v + p).astype(np.float32)
    return v


@pytest.mark.parametrize("S", [3, 8, 16])
def test_fixed_order_sum_is_the_same_bits_in_any_block_order(S):
    """Each split's part, its own k-tiles summed in order (one block's
    accumulator), stored to its own slot, then summed 0..S-1: whatever
    order the blocks finish in, the same bits. Adding the parts into a
    zeroed output as they finish (the atomics this replaced) gives other
    bits for other orders (from three parts on: two add commutatively)."""
    rng = np.random.RandomState(S)
    K_, n = 16 * S * 5, 4096
    a = rng.randn(K_, n).astype(np.float32)
    parts = []
    for tiles in f32_ranges(K_, S):
        acc = np.zeros(n, np.float32)
        for t in tiles:
            acc = (acc + a[t * 16:(t + 1) * 16].sum(0, dtype=np.float32)
                   ).astype(np.float32)
        parts.append(acc)
    fixed, atomic = set(), set()
    for trial in range(6):
        order = rng.permutation(S)
        slots = [None] * S
        for s in order:  # the blocks finish in this order
            slots[s] = parts[s]
        fixed.add(_split_sum(slots[0], slots[1:]).tobytes())
        out = np.zeros(n, np.float32)
        for s in order:
            out = (out + parts[s]).astype(np.float32)
        atomic.add(out.tobytes())
    assert len(fixed) == 1
    assert len(atomic) > 1
    np.testing.assert_allclose(np.frombuffer(fixed.pop(), np.float32),
                               a.astype(np.float64).sum(0), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("n,grid", [(4096, 3), (130, 1), (100_003, 528),
                                    (1_048_576, 528)])
def test_split_sum_stores_each_element_once(n, grid):
    """split_sum_kernel's grid-stride walk (kThreads a block; 16 bytes a
    thread where the segment's length allows, one float else): every
    element of a segment summed and stored by exactly one thread."""
    stride = grid * 256
    width = 4 if n % 4 == 0 else 1
    seen = np.zeros(n, int)
    for t0 in range(min(stride, n // width)):
        i = np.arange(t0, n // width, stride)
        for k in range(width):
            seen[width * i + k] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# (b) the library sites
# ---------------------------------------------------------------------------


def _ctc_case(seed=0, B=6, T=12, L=4, V=7):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(B, T, V) * 2).astype(np.float32))
    label_lens = torch.tensor([4, 4, 0, 4, 0, 2], dtype=torch.int32)
    labels = torch.from_numpy(rng.randint(1, V, size=(B, L)).astype(np.int32))
    labels[1] = torch.tensor([3, 3, 5, 5])
    labels = labels * (torch.arange(L)[None] < label_lens[:, None])
    input_lens = torch.tensor([12, 10, 6, 3, 0, 5], dtype=torch.int32)
    return logits, input_lens, labels, label_lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_posterior_one_hot_equals_the_scatter(seed):
    """The CTC posterior over the vocabulary as the JAX package's one-hot
    product (ops/ctc.py's backward) against the scatter-add it replaced,
    on the same state posteriors: only the order of the f32 sums
    differs."""
    logits, input_lens, labels, label_lens = _ctc_case(seed)
    B, T, V = logits.shape
    logp = torch.log_softmax(logits, -1)
    ext, skip, valid, tmask = C._lattice(T, input_lens, labels, label_lens, 0)
    emit = C._gather_states(logp, ext)
    alpha = C._alpha_plain(emit, tmask, skip, valid)
    ll = C._log_likelihood(alpha, label_lens)
    post = C._beta_post_plain(emit, tmask, skip, valid, 2 * label_lens,
                              alpha, ll)
    scatter = torch.zeros_like(logp).scatter_add_(
        2, ext.long()[:, None, :].expand(B, T, ext.shape[1]),
        post.permute(1, 0, 2))
    onehot = torch.einsum("tbs,bsv->btv", post,
                          torch.nn.functional.one_hot(ext.long(), V).float())
    np.testing.assert_allclose(onehot.numpy(), scatter.numpy(), rtol=0,
                               atol=1e-6)
    # and through the loss's backward, the analytic gradient
    lg = logits.clone().requires_grad_(True)
    C.ctc_loss(lg, input_lens, labels, label_lens).sum().backward()
    ok = C._feasible(input_lens, labels, label_lens)
    want = (torch.exp(logp) - scatter) * tmask.T[:, :, None]
    want = torch.where(ok[:, None, None], want, 0.0)
    np.testing.assert_allclose(lg.grad.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("N,V,E", [(1, 5, 3), (9312, 31, 64), (700, 132, 16)])
def test_embedding_gradient_one_hot_equals_index_add_and_jax(N, V, E):
    """K4's embedding gradient (``las_decoder.weight_grads``) as a one-hot
    product (``ops/onehot.py::rows_sum``) against the ``index_add_`` it
    replaced and against JAX's ``.at[].add`` (pallas_decoder.py:867), with
    many repeated tokens: only the order of the f32 sums differs."""
    rng = np.random.RandomState(N)
    ids = rng.randint(0, V, size=N)
    src = rng.randn(N, E).astype(np.float32)
    got = rows_sum(torch.from_numpy(ids), torch.from_numpy(src), V).numpy()
    old = torch.zeros(V, E).index_add_(0, torch.from_numpy(ids),
                                       torch.from_numpy(src)).numpy()
    ref = np.asarray(jnp.zeros((V, E), jnp.float32).at[ids].add(src))
    tol = 2e-6 * np.abs(old).max()
    np.testing.assert_allclose(got, old, rtol=0, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_weight_grads_take_the_embedding_gradient_as_rows_sum():
    """las_decoder.weight_grads' "embed" entry is rows_sum over the
    teacher-forced tokens (no index_add_ left in the module)."""
    rng = np.random.RandomState(0)
    B, L, V, E = 3, 5, 11, 4
    tok = torch.from_numpy(rng.randint(0, V, size=(B, L)).astype(np.int32))
    demb = torch.from_numpy(rng.randn(B, L, E).astype(np.float32))
    want = torch.zeros(V, E).index_add_(0, tok.reshape(-1).long(),
                                        demb.reshape(-1, E))
    got = rows_sum(tok.reshape(-1), demb.reshape(-1, E), V)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with open(LD.__file__) as f:
        assert "index_add_(" not in f.read()


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4)])
def test_embed_gradient_is_the_rows_sum(shape):
    """ops/onehot.py::embed: the rows of the table, and a gradient equal to
    autograd's through ``table[ids]`` (an accumulating index_put on the
    card), taken as rows_sum."""
    rng = np.random.RandomState(len(shape))
    V, E = 6, 5
    table = torch.from_numpy(rng.randn(V, E).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, V, size=shape))
    g = torch.from_numpy(rng.randn(*shape, E).astype(np.float32))
    t1, t2 = (table.clone().requires_grad_(True) for _ in range(2))
    out = embed(t1, ids)
    assert torch.equal(out, table[ids])
    out.backward(g)
    t2[ids].backward(g)
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), atol=1e-6)


def test_vgg_convolution_backward_runs_under_deterministic_cudnn():
    """VGG2L's Conv3x3: its backward (a convolution_backward) runs with
    cuDNN's deterministic algorithms chosen and TF32 off, inside the
    module, while the process's flags stay as they were; its gradients
    equal autograd's through ``conv2d``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.startswith("convolution_backward"):
                seen.append((torch.backends.cudnn.deterministic,
                             torch.backends.cudnn.allow_tf32,
                             torch.backends.cudnn.benchmark))
            return func(*args, **(kwargs or {}))

    torch.manual_seed(0)
    conv = Conv3x3(3, 4)
    torch.nn.init.normal_(conv.kernel)
    x = torch.randn(2, 3, 9, 7, requires_grad=True)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32)
    with Watch():
        conv(x, torch.float32).square().sum().backward()
    assert seen and all(s == (True, False, False) for s in seen)
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == before
    xr = x.detach().clone().requires_grad_(True)
    w = conv.kernel.detach().clone().requires_grad_(True)
    b = conv.bias.detach().clone().requires_grad_(True)
    torch.nn.functional.conv2d(xr, w.permute(3, 2, 0, 1), b,
                               padding=1).square().sum().backward()
    for got, want in ((x.grad, xr.grad), (conv.kernel.grad, w.grad),
                      (conv.bias.grad, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (c) no float atomics on the gradient path
# ---------------------------------------------------------------------------

ATOMIC = re.compile(r"\batomic(?:Add|Sub|Exch|Min|Max|CAS|Inc|Dec)\w*\s*\(|"
                    r"\bred\.(?:global|shared)|\batom\.(?:global|shared)")
# (file, the source line): the tiled products' AtomicAdd epilogue and
# colsum_kernel (only the build variants K1_F32_TILED 0 and
# K1B_WGMMA_PRODUCTS 0 instantiate them) and FE_TIMING's integer counters.
ALLOWED = {
    ("gemm.cuh", "atomicAdd(p + (size_t)m * ld + n, v);"),
    ("bilstm_bwd.cu", "atomicAdd(db + n, s);"),
    ("frontend.cu",
     "atomicAdd(fe_phase_cycles + p, (unsigned long long)fe_acc[p]);"),
    ("frontend.cu", "atomicAdd(fe_phase_cycles + kPhases, 1ull);"),
}


def test_every_atomic_in_the_sources_is_allowed():
    found = set()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path) as f:
            for line in f:
                code = line.split("//")[0]
                if ATOMIC.search(code):
                    found.add((os.path.basename(path), code.strip()))
    assert found == ALLOWED


def _guarded(path, needle, macro):
    """(lines of ``path`` holding ``needle``, whether each sits inside an
    ``#if`` naming ``macro``)."""
    stack, lines, ok = [], 0, True
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("#if"):
                stack.append(s)
            elif s.startswith("#endif"):
                stack.pop()
            elif needle in line.split("//")[0]:
                lines += 1
                ok = ok and any(macro in d for d in stack)
    return lines, ok


def test_the_allowed_atomics_are_variant_or_timing_code():
    """colsum_kernel and every use of AtomicAdd lie inside
    ``#if K1_TILED_VARIANT`` (false in the default build: both defines
    are 1), FE_TIMING's counters inside ``#if FE_TIMING`` (0), and no
    other source names AtomicAdd."""
    bwd = os.path.join(CSRC, "bilstm_bwd.cu")
    n, ok = _guarded(bwd, "atomicAdd(db + n, s);", "K1_TILED_VARIANT")
    assert n == 1 and ok
    n, ok = _guarded(bwd, "AtomicAdd", "K1_TILED_VARIANT")
    assert n >= 1 and ok
    with open(bwd) as f:
        text = f.read()
    for define in ("#define K1_F32_TILED 1", "#define K1B_WGMMA_PRODUCTS 1",
                   "#define K1_TILED_VARIANT (!K1_F32_TILED || "
                   "!K1B_WGMMA_PRODUCTS)"):
        assert define in text
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        if os.path.basename(path) not in ("gemm.cuh", "bilstm_bwd.cu"):
            with open(path) as f:
                assert "AtomicAdd" not in f.read(), path
    fe = os.path.join(CSRC, "frontend.cu")
    n, ok = _guarded(fe, "atomicAdd(fe_phase_cycles", "FE_TIMING")
    assert n == 2 and ok
    with open(fe) as f:
        assert "#define FE_TIMING 0" in f.read()


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(CSRC, "*.cu"))))
def test_the_default_build_compiles_no_float_atomic(name, tmp_path):
    """Each library as _build.py compiles it, through the C preprocessor
    (the CUDA headers stubbed: only this repository's text matters): no
    float atomic or reduction PTX is left but gemm.cuh's AtomicAdd
    epilogue, which nothing in the build instantiates."""
    for header in ("cuda_runtime.h", "cuda_bf16.h", "cuda.h", "mma.h",
                   "cooperative_groups.h"):
        (tmp_path / header).write_text("")
    out = subprocess.run(
        ["g++", "-E", "-P", "-x", "c++", "-std=c++17", f"-I{tmp_path}",
         "-D__CUDACC__", "-D__CUDA_ARCH__=900", os.path.join(CSRC, name)],
        capture_output=True, text=True, check=True).stdout
    hits = [line.strip() for line in out.splitlines() if ATOMIC.search(line)]
    assert set(hits) <= {"atomicAdd(p + (size_t)m * ld + n, v);"}, hits
    uses = [line for line in out.splitlines() if "AtomicAdd" in line]
    assert uses == [] or uses == ["struct AtomicAdd {"], uses


def test_stacked_decoder_loc_band_equals_the_gather():
    """models/decoder.py::build_loc_band (the stacked decoder's plain loc
    path) reorders the channel-major band: the same entries, bit for bit,
    as gathering the filter by the [T, T] tap index (whose backward
    scattered T*T*C entries onto w*C), and the same filter gradient."""
    from gluon_e2e_asr_tpu_torch.models.decoder import AttentionDecoder

    config = load_config(os.path.join(REPO, "configs", "flagship_bf16.yaml"))
    dec = AttentionDecoder(config.model, 32, 2, 3)
    dec.reset_parameters(torch.Generator().manual_seed(0))
    w, C = config.model.loc_conv_width, config.model.loc_conv_channels
    for T in (1, 37, 100, 260):
        band = dec.build_loc_band(T)
        k = torch.arange(T)[:, None] - torch.arange(T)[None, :] + (w - 1) // 2
        valid = ((k >= 0) & (k < w))[..., None]
        f = dec.loc_filter.detach().clone().requires_grad_(True)
        old = torch.where(valid, f[k.clamp(0, w - 1), 0, :],
                          torch.zeros(())).reshape(T, T * C)
        assert torch.equal(band, old)
        g = torch.randn(T, T * C, generator=torch.Generator().manual_seed(T))
        old.backward(g)
        band.backward(g)
        np.testing.assert_allclose(dec.loc_filter.grad.numpy(),
                                   f.grad.numpy(), rtol=1e-6, atol=1e-5)
        dec.loc_filter.grad = None


@pytest.mark.parametrize("sets", [
    (), ("model.att_type=loc",), ("model.att_type=add",),
    ("model.dec_layers=2", "model.att_type=loc"),
    ("train.accum_grad_steps=2",), ("model.enc_dropout=0.1",)])
def test_a_training_step_runs_no_accumulating_op(sets):
    """One update of the tiny golden config (hybrid CTC/attention) through
    the port on the CPU under chip_smoke.py's dispatch audit: none of its
    library operations adds into one address from several indices (the
    forms whose CUDA kernels add atomically, in an order that varies),
    in each training form; phase 6e runs the same audit on the card at the
    configs' widths."""
    config = load_config(TINY)
    apply_overrides(config, list(sets))
    batch, tok = chip_smoke.repro_batch(torch, TINY, "bucket")
    audit = chip_smoke.accumulation_audit(torch, "cpu")
    with audit:
        chip_smoke.repro_run(torch, config, tok, batch, torch.device("cpu"),
                             1)
    assert audit.accumulating == {} and audit.convs == 0


def test_largest_repro_case_is_ls100s_largest_bucket():
    """Phase 6e's ``ls100_full, largest bucket`` case (REPRO_CASES'
    "largest" batch): ls100_full.yaml's largest bucket on synthetic audio,
    B = 32 at 18.38 s (T = 1836 frames), labels of up to 320 tokens in the
    BPE 128 vocabulary built from the corpus's train texts (no audio
    rendered), trained with repro_cmvn's global CMVN stats. Cut to two
    rows of one second at test widths, it trains on the CPU under the
    dispatch audit with no accumulating op, and two runs are equal."""
    case = next(c for c in chip_smoke.REPRO_CASES if c[3] == "largest")
    assert case[1] == chip_smoke.LS100_CONFIG
    batch, tok = chip_smoke.repro_batch(torch, case[1], "largest")
    config, shape = chip_smoke.repro_config(case)
    fc = config.frontend
    B, S = batch["audio"].shape
    assert (B, num_frames(S, fc.win_length, fc.hop_length)) == (32, 1836)
    assert chip_smoke.ls100_case()[1:] == (32, 320, (0, 1836, 80))
    assert tok.vocab_size == config.data.bpe_vocab_size == 128
    assert batch["labels"].shape == (32, 320)
    assert int(batch["label_len"].max()) <= 320
    assert 4 <= int(batch["labels"][batch["labels"] > 0].min())
    assert int(batch["labels"].max()) < tok.vocab_size
    mean, std = chip_smoke.repro_cmvn(torch, config, torch.device("cpu"))
    assert mean.shape == std.shape == (fc.n_mels,) and bool((std > 0).all())
    mc = config.model
    mc.enc_hidden = mc.dec_hidden = 8
    mc.dec_embed, mc.att_dim = 6, 8
    mc.loc_conv_channels, mc.loc_conv_width = 4, 7
    cut = {k: v[:2] for k, v in batch.items()}
    cut["audio"] = cut["audio"][:, :16000].contiguous()
    cut["audio_len"] = torch.clamp(cut["audio_len"], max=16000)
    cut["labels"] = cut["labels"][:, :12].contiguous()
    cut["label_len"] = torch.clamp(cut["label_len"], max=12)
    audit = chip_smoke.accumulation_audit(torch, "cpu")
    with audit:
        runs = [chip_smoke.repro_run(torch, config, tok, cut,
                                     torch.device("cpu"), 2)
                for _ in range(2)]
    assert audit.accumulating == {} and audit.convs == 0
    assert chip_smoke.state_diff(torch, *runs)["equal"]
