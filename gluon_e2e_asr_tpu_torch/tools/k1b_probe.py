"""K1-bwd alone on the card: the whole call, its reverse recurrence and
its products.

Times ``ops/bilstm.py::bilstm_fused_bwd_kernel`` (the recurrence, the
products dx, dW_x, dW_h and db) and ``bilstm_fused_bwd_recur_kernel``
(the recurrence alone) by CUDA events at the flagship's three layer
shapes (B=96, H=320, the 4.0 s bucket: T 398/199/100) and milestone 2's
(B=16, H=256), f32 and bf16, on seeded inputs from K1-fwd's training
form. Run from the root of a checkout on a machine with the card and
nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.k1b_probe [--iters 10] [--ablate]
    python -m gluon_e2e_asr_tpu_torch.tools.k1b_probe --products [--dtype float32]

Each shape prints one JSON line: ms of the whole call and of the
recurrence, the products as their difference, microseconds a step of the
recurrence, the card's name and power limit.

``--products`` times the products alone instead (bf16, through
``bilstm_fused_bwd_products_kernel`` on the reverse recurrence's dg), at
each shape, in one process: the wgmma kernels, cuBLAS on the same
bf16-rounded operands (``products_library``: torch.matmul of dx, dW_x
and the two dW_h, and torch.sum for db; the port never calls it), and
the WMMA kernel they replaced (``gemm.cuh::gemm_bf16_kernel``, built
with ``csrc/bilstm_bwd.cu``'s ``K1B_WGMMA_PRODUCTS`` 0, ``PRODUCTS_WMMA``),
each with its TFLOP/s over the live frames and its share of the bound
(``products_work``: the operations over the live frames at 989 TFLOP/s,
or the bytes at 3.35 TB/s, the larger). With ``--ablate`` as well, it
times the wgmma kernels with one piece cut or changed at a time
(``PRODUCTS_CUTS``; a cut computes wrong results, only its time counts),
and each kernel's device time (torch.profiler) in every variant.

``--products --dtype float32`` times the f32 route instead, at the
milestones' three layer shapes (``F32_SHAPES``: B=16, H=256, the 4.0 s
bucket; every milestone and both english recipes run f32), on the f32
recurrence's dg, in one process: the kernels (``csrc/gemm_f32.cuh``'s
``ring_kernel``), the kernels they replaced (``gemm.cuh``'s
``gemm_f32_kernel`` and ``colsum_kernel``, built with
``csrc/bilstm_bwd.cu``'s ``K1_F32_TILED`` 0, ``F32_OLD``), their plain
twin and cuBLAS in f32 on the same operands (TF32 off;
``products_library`` without the rounding), each with its TFLOP/s over
the live frames and its share of the f32 bound (``products_work``'s
operations at 67 TFLOP/s, or the bytes) and the kernels' device time
by name (torch.profiler).

``--ablate`` also builds ``csrc/bilstm_bwd.cu`` with one piece of the
cluster recurrence's step cut at a time (``CUTS``; each such build
computes wrong results, only its time counts) and times the recurrence
of the flagship's layer 0 in f32 and bf16 with each, in the same process
as the kernel as it is: the time a piece costs is the difference. Two
more builds there are comparisons, not cuts: the cluster kernel with 48
rows a cluster whatever B is, and ``bwd_recur_kernel`` (the design
before the cluster kernel, W_h from L2 every step) in its place.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.ops import bilstm as K

# (name, B, T, D, H): the flagship's layers at the 4.0 s bucket,
# milestone 2's first layer at its 4.0 s bucket and ls100_full.yaml's
# first layer at its 18.38 s bucket (its dynamic batch there).
SHAPES = (("flagship layer 0", 96, 398, 80, 320),
          ("flagship layer 1", 96, 199, 1280, 320),
          ("flagship layer 2", 96, 100, 1280, 320),
          ("milestone2 layer 0", 16, 398, 80, 256),
          ("ls100_full 18.38 s layer 0", 32, 1836, 80, 320))
# name -> [(text of csrc/bilstm_bwd.cu or of csrc/common.cuh, its
# replacement)]: each cuts one piece of bwd_cluster_kernel's step.
CUTS = {
    "product": [("      for (int j = 0; j < J; ++j) {",
                 "      for (int j = 0; j < 0; ++j) {")],
    # partials go to this CTA's own buffer, not to their owners
    "exchange": [("      dst = cluster.map_shared_rank(dst, owner);\n", "")],
    # a CTA barrier where the cluster barrier ends the step, and one
    # cluster barrier after the loop, so that no CTA exits while another
    # may still store into its shared memory
    "cluster barrier": [
        ("    cluster_arrive();\n", "    __syncthreads();\n"),
        ("    cluster_wait();\n  }\n}\n", "  }\n  cluster.sync();\n}\n")],
    "stream loads": [("      fetch(s + 1);\n", "")],
    "dg stores": [("    if (!on || b >= B || u0 >= H) return;",
                   "    return;")],
    # not cuts: the kernel with 48 rows a cluster whatever B is, and
    # bwd_recur_kernel, the design before the cluster kernel, on the same
    # inputs (W_h in the other layout, of the same size)
    "48 rows a cluster": [("  for (int r = kRowStep; r <= kMaxRows;",
                           "  for (int r = kMaxRows + 1; r <= kMaxRows;")],
    "cluster design (bwd_recur_kernel instead)": [
        ("  if (H <= kClusterMaxHidden) {\n    return cd_bf16",
         "  if (false) {\n    return cd_bf16")],
}


# (name, B, T, D, H): the milestones' layers at the 4.0 s bucket
# (enc_subsample [1, 2, 2]; milestone 2's are the same), the f32 route's.
F32_SHAPES = (("milestone layer 0", 16, 398, 80, 256),
              ("milestone layer 1", 16, 199, 1024, 256),
              ("milestone layer 2", 16, 100, 1024, 256))
# The f32 kernels' names (ring_kernel's namespace; the first kernels),
# the fixed-order sum of the splits' parts (split_sum_kernel) and the
# memsets of the first kernels' zeroed outputs, in a profiler trace.
F32_KERNELS = ("gemm_f32", "proj_f32_kernel", "colsum_kernel", "split_sum",
               "Memset")
# The bf16 products' kernels (dx_kernel, wgrad_kernel) and the fixed-order
# sum of wgrad_kernel's splits, in a profiler trace.
BF16_KERNELS = ("gemm_sm90", "split_sum")
# The build variant of csrc/bilstm_bwd.cu and csrc/bilstm_fwd.cu with the
# f32 route's first kernels in place of ring_kernel.
F32_OLD = {"old": [("#define K1_F32_TILED 1", "#define K1_F32_TILED 0")]}
# name -> [(text of csrc/gemm_f32.cuh, its replacement)]: each changes or
# cuts one piece of ring_kernel (a cut computes wrong results, only its
# time counts).
F32_CUTS = {
    # not cuts: one block an SM (at most 255 registers a thread, the
    # plan's splits for one wave of one block an SM), k-tiles of 32 in 3
    # stages, a ring of 2 stages
    "1 block an SM": [("constexpr int kBlocksPerSm = 2;",
                       "constexpr int kBlocksPerSm = 1;")],
    "k-tiles of 32": [("constexpr int kBK = 16;           // depth of a stage",
                       "constexpr int kBK = 32;           // depth of a stage"),
                      ("constexpr int kStages = 4;        // the ring",
                       "constexpr int kStages = 3;        // the ring")],
    "2 stages": [("constexpr int kStages = 4;        // the ring",
                  "constexpr int kStages = 2;        // the ring")],
    "no FMAs": [("      multiply<kAOuter, kBOuter>(As + s * kAF, Bs + s * kBF, acc, tid);\n",
                 "")],
    # the stores skipped at run time (M > 0), the products kept
    "no stores": [("    if (m < 0) continue;\n    if constexpr (kBOuter) {",
                   "    if (m < 0 || M > 0) continue;\n    if constexpr (kBOuter) {")],
    "no loads": [("    if (op.vec) {\n      cp16(dst, src, n);\n    } else {\n"
                  "#pragma unroll\n      for (int i = 0; i < 4; ++i) cp4(dst + i, i < n ? src + i : op.base(), i < n);\n"
                  "    }\n",
                  "    (void)src;\n    (void)dst;\n")],
}


# The build variant with the WMMA products in place of the wgmma kernels.
PRODUCTS_WMMA = {"wmma": [("#define K1B_WGMMA_PRODUCTS 1",
                           "#define K1B_WGMMA_PRODUCTS 0")]}
# name -> [(text of csrc/bilstm_bwd.cu or a header it includes, its
# replacement)]: each cuts or changes one piece of the wgmma products.
PRODUCTS_CUTS = {
    "no conversion": [("    plan.convert(w.x, s.staged(k), s.a(st), s.b(st), p);\n",
                    "")],
    "no wgmma": [("      for (int j = 0; j < kBK / 16; ++j) "
               "wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j);\n", "")],
    # not cuts: a retry counter that traps after 2^26 tries in the barrier
    # wait, and one producer warpgroup where there are two
    "watchdog in the wait": [('      "@!p bra WAIT;\\n"\n',
                              '      "@p bra DONE;\\n"\n'
                              '      "add.u32 n, n, 1;\\n"\n'
                              '      "setp.gt.u32 p, n, 67108864;\\n"\n'
                              '      "@p trap;\\n"\n'
                              '      "bra WAIT;\\n"\n'
                              '      "DONE:\\n"\n'),
                             ('      ".reg .pred p;\\n"\n',
                              '      ".reg .pred p;\\n"\n'
                              '      ".reg .u32 n;\\n"\n'
                              '      "mov.u32 n, 0;\\n"\n')],
    "one producer warpgroup": [("constexpr int kProducers = 2;",
                                "constexpr int kProducers = 1;")],
}
# H100 SXM, NVIDIA's data sheet: bf16 tensor cores, f32 FMA units, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def products_work(lens, T: int, D: int, H: int):
    """(operations, bytes) of K1-bwd's products at one layer: dx, dW_x and
    dW_h of both directions over the live frames (sum of lens); in, dg, x
    and y of the live frames (f32, as the entry takes them), W_x and lens;
    out, dx [B,T,D], dW_x, db and dW_h."""
    B = len(lens)
    frames = float(sum(int(n) for n in lens))
    ops = 2 * 2.0 * frames * 8 * H * D + 2 * 2.0 * frames * H * 4 * H
    nbytes = (4 * frames * (8 * H + D + 2 * H) + 4 * D * 8 * H + 4 * B
              + 4 * (B * T * D + D * 8 * H + 8 * H + 2 * H * 4 * H))
    return ops, nbytes


def products_bound(lens, T: int, D: int, H: int, peak: float = PEAK_BF16):
    """(ms, "operations" or "bytes"): the least time of the products on
    the H100, the operations at ``peak`` FLOP/s."""
    ops, nbytes = products_work(lens, T, D, H)
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def products_library(x, w_x, y, dg, dtype=torch.bfloat16):
    """cuBLAS on the products' operands in ``dtype`` (bf16: rounded here),
    h_prev shifted here, outside the timing: a function that runs
    torch.matmul for dx, dW_x and the two dW_h (out in ``dtype``; f32
    with TF32 off, as the caller sets it) and torch.sum for db. A
    yardstick: the port never calls it."""
    H, D = dg.shape[-1] // 8, x.shape[-1]
    g = dg.to(dtype).reshape(-1, 8 * H)
    gf, gb = g[:, :4 * H].contiguous(), g[:, 4 * H:].contiguous()
    xb, wb = x.to(dtype).reshape(-1, D), w_x.to(dtype)
    yb = y.to(dtype)
    zero = torch.zeros_like(yb[:, :1, :H])
    hf = torch.cat([zero, yb[:, :-1, :H]], 1).reshape(-1, H)
    hb = torch.cat([yb[:, 1:, H:], zero], 1).reshape(-1, H)

    def run():
        torch.matmul(g, wb.T)
        torch.matmul(xb.T, g)
        torch.matmul(hf.T, gf)
        torch.matmul(hb.T, gb)
        torch.sum(dg, (0, 1))
    return run


def layer(B, T, D, H, dev, seed=0):
    """Seeded K1 layer inputs and a cotangent, as chip_smoke.py makes
    them."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    arrays = (rng.randn(B, T, D).astype(np.float32), lens,
              (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
              (rng.randn(8 * H) * 0.1).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    dy = rng.randn(B, T, 2 * H).astype(np.float32)
    return (tuple(torch.from_numpy(a).to(dev) for a in arrays),
            torch.from_numpy(dy).to(dev))


def event_ms(fn, iters: int) -> float:
    """Median ms of ``fn`` over ``iters`` calls (CUDA events), after two."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_cuts(out_dir: str, name: str = "bilstm_bwd",
               cuts: dict = CUTS) -> dict:
    """cut -> the library of csrc/<name>.cu with that cut, one nvcc each,
    all started together. Each (old, new) of a cut replaces text that
    occurs once in the source and the headers of ``csrc/`` together,
    whose edited copies sit beside the source (a quoted include resolves
    there first)."""
    texts = {}
    for f in [f"{name}.cu"] + sorted(
            f for f in os.listdir(_build.SRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(_build.SRC_DIR, f)) as fh:
            texts[f] = fh.read()

    def build(cut):
        files = dict(texts)
        for old, new in cuts[cut]:
            hit = [f for f, text in files.items() if old in text]
            if len(hit) != 1 or files[hit[0]].count(old) != 1:
                raise RuntimeError(f"cut {cut!r}: {old!r} is not once in "
                                   "the source and its headers")
            files[hit[0]] = files[hit[0]].replace(old, new)
        d = os.path.join(out_dir, cut.split(" (")[0].replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, f"lib{name}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               _build.SRC_DIR, "-o", lib,
                               os.path.join(d, f"{name}.cu")],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"cut {cut!r}: nvcc failed\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(cuts)) as pool:
        paths = dict(zip(cuts, pool.map(build, cuts)))
    return {cut: ctypes.CDLL(p) for cut, p in paths.items()}


def kernel_ms(fn, name, runs: int = 5, args: bool = False) -> dict:
    """Device ms of each kernel whose name holds ``name`` (a string, or a
    tuple of them) in one call of ``fn`` (torch.profiler, the mean of
    ``runs``); with ``args``, a template's instances apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    names = (name,) if isinstance(name, str) else name
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0)
        if us > 0 and any(n in evt.key for n in names):
            short = kernel_name(evt.key, args)
            out[short] = out.get(short, 0.0) + us / 1e3 / runs
    return out


def kernel_name(key: str, args: bool = False) -> str:
    """A profiler key's kernel name without its namespace, template
    arguments and parameters: ``void gemm_f32::ring_kernel<...>(...)`` ->
    ``ring_kernel``; ``Memset (Device)`` -> ``Memset``. With ``args`` a
    template keeps its arguments' last names: ``ring_kernel<RowMajor,
    Transposed, Store>``."""
    k = key[5:] if key.startswith("void ") else key
    k = k.replace("(anonymous namespace)::", "")
    name = k.split("<")[0].split("(")[0].strip().split("::")[-1]
    if args and "<" in k.split("(")[0]:
        inner = k[k.index("<") + 1:k.index(">(") if ">(" in k else None]
        name += "<" + ", ".join(a.strip().split("::")[-1]
                                for a in inner.split(",")) + ">"
    return name


def products(iters: int, dev, card: str, ablate: bool) -> dict:
    """--products: the products alone at each shape, bf16, the wgmma
    kernels, cuBLAS and the WMMA variant in one process; with ``ablate``
    the PRODUCTS_CUTS variants too."""
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "k1b_cuts"),
                      cuts={**PRODUCTS_WMMA, **(PRODUCTS_CUTS if ablate else {})})
    wmma = cuts.pop("wmma")
    kernel_lib = _build.load_library("bilstm_bwd")
    bf = torch.bfloat16
    results = {}
    for name, B, T, D, H in SHAPES:
        (x, lens, w_x, b_x, w_hf, w_hb), dy = layer(B, T, D, H, dev)
        y, c, acts = K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb, bf,
                                           with_cell=True)
        dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, bf)
        run = lambda: K.bilstm_fused_bwd_products_kernel(  # noqa: E731
            x, lens, w_x, y, dg, bf)
        ms = {"wgmma": event_ms(run, iters)}
        by_kernel = {"wgmma": kernel_ms(run, BF16_KERNELS)}
        try:
            _build._libs["bilstm_bwd"] = wmma
            ms["wmma"] = event_ms(run, iters)
            for cut, lib in cuts.items():
                _build._libs["bilstm_bwd"] = lib
                ms[cut] = event_ms(run, iters)
                by_kernel[cut] = kernel_ms(run, BF16_KERNELS)
        finally:
            _build._libs["bilstm_bwd"] = kernel_lib
        ms["cublas"] = event_ms(products_library(x, w_x, y, dg), iters)
        lens_h = lens.cpu().tolist()
        ops, _ = products_work(lens_h, T, D, H)
        bound_ms, bound_by = products_bound(lens_h, T, D, H)
        rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
               "compute_dtype": "bfloat16",
               **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_tflops_live": ops / v / 1e9 for k, v in ms.items()},
               "bound_ms": bound_ms, "bound_by": bound_by,
               **{f"{k}_share_of_bound": bound_ms / v for k, v in ms.items()},
               "kernel_ms": by_kernel, "card": card}
        results[name] = rec
        print(json.dumps(rec), flush=True)
    return results


def f32_inputs(B, T, D, H, dev):
    """A milestone layer's x, lens, w_x, K1-fwd's f32 h stream y (the
    training form) and the f32 reverse recurrence's dg on them."""
    (x, lens, w_x, b_x, w_hf, w_hb), dy = layer(B, T, D, H, dev)
    f32 = torch.float32
    y, c, acts = K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb, f32,
                                       with_cell=True)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, f32)
    return x, lens, w_x, y, dg


def products_f32(iters: int, dev, card: str, ablate: bool) -> dict:
    """--products --dtype float32: the f32 products alone at F32_SHAPES,
    ring_kernel, the first kernels (F32_OLD), their plain twin and cuBLAS
    in f32, in one process; with ``ablate`` the F32_CUTS variants too."""
    variants = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "k1b_cuts"),
                          cuts={**F32_OLD, **(F32_CUTS if ablate else {})})
    kernel_lib = _build.load_library("bilstm_bwd")
    f32 = torch.float32
    results = {}
    for name, B, T, D, H in F32_SHAPES:
        x, lens, w_x, y, dg = f32_inputs(B, T, D, H, dev)
        run = lambda: K.bilstm_fused_bwd_products_kernel(  # noqa: E731
            x, lens, w_x, y, dg, f32)
        ms, device = {}, {}
        try:  # every event timing before the first profiler run
            for profile in (False, True):
                for variant, lib in (("kernel", kernel_lib),
                                     *variants.items()):
                    _build._libs["bilstm_bwd"] = lib
                    if profile:
                        device[variant] = kernel_ms(run, F32_KERNELS,
                                                    args=True)
                    else:
                        ms[variant] = event_ms(run, iters)
        finally:
            _build._libs["bilstm_bwd"] = kernel_lib
        ms["plain"] = event_ms(lambda: K.bilstm_fused_bwd_products_plain(
            x, lens, w_x, y, dg, f32), iters)
        ms["cublas"] = event_ms(products_library(x, w_x, y, dg, f32), iters)
        lens_h = lens.cpu().tolist()
        ops, _ = products_work(lens_h, T, D, H)
        bound_ms, bound_by = products_bound(lens_h, T, D, H, PEAK_F32)
        rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
               "compute_dtype": "float32", "live_frames": sum(lens_h),
               **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_tflops_live": ops / v / 1e9 for k, v in ms.items()},
               "bound_ms": bound_ms, "bound_by": bound_by,
               **{f"{k}_share_of_bound": bound_ms / v for k, v in ms.items()},
               "kernel_device_ms": device, "card": card}
        results[name] = rec
        print(json.dumps(rec), flush=True)
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--products", action="store_true")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="--products: the bf16 (wgmma) or the f32 route")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1b_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    _build.build_all(["bilstm_fwd", "bilstm_bwd"])
    if args.products:
        if args.dtype == "float32":
            return products_f32(args.iters, dev, card, args.ablate)
        return products(args.iters, dev, card, args.ablate)
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "k1b_cuts")) if args.ablate else {}
    results = {}
    for name, B, T, D, H in SHAPES:
        (x, lens, w_x, b_x, w_hf, w_hb), dy = layer(B, T, D, H, dev)
        for cd in (torch.float32, torch.bfloat16):
            y, c, acts = K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                                               cd, with_cell=True)
            whole = event_ms(lambda: K.bilstm_fused_bwd_kernel(
                x, lens, w_x, w_hf, w_hb, y, c, acts, dy, cd), args.iters)
            recur = lambda: K.bilstm_fused_bwd_recur_kernel(  # noqa: E731
                lens, w_hf, w_hb, c, acts, dy, cd)
            r_ms = event_ms(recur, args.iters)
            rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
                   "compute_dtype": str(cd).split(".")[1], "whole_ms": whole,
                   "recur_ms": r_ms, "products_ms": whole - r_ms,
                   "recur_us_per_step": r_ms * 1e3 / T,
                   "cluster": H <= K.CLUSTER_MAX_HIDDEN, "card": card}
            if cuts and name == SHAPES[0][0]:
                kernel_lib = _build._libs["bilstm_bwd"]
                rec["recur_us_per_step_without"] = {}
                for cut, lib in cuts.items():
                    _build._libs["bilstm_bwd"] = lib
                    try:
                        rec["recur_us_per_step_without"][cut] = \
                            event_ms(recur, args.iters) * 1e3 / T
                    finally:
                        _build._libs["bilstm_bwd"] = kernel_lib
            results[(name, rec["compute_dtype"])] = rec
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
