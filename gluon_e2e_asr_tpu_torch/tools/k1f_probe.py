"""K1-fwd alone on the card: the whole call, its recurrence and its
projection.

Times ``ops/bilstm.py::bilstm_fused_kernel`` (the projection and the
recurrence), ``bilstm_fused_fwd_recur_kernel`` (the recurrence alone,
over the same projection) and ``bilstm_fused_proj_kernel`` (the
projection alone) by CUDA events at the flagship's three layer shapes
(B=96, H=320, the 4.0 s bucket: T 398/199/100) and milestone 2's (B=16,
H=256), f32 and bf16, in the serving and the training form, on seeded
inputs. Run from the root of a checkout on a machine with the card and
nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.k1f_probe [--iters 10] [--ablate]
    python -m gluon_e2e_asr_tpu_torch.tools.k1f_probe --proj [--ablate]
    python -m gluon_e2e_asr_tpu_torch.tools.k1f_probe --proj --dtype float32

Each shape, dtype and form prints one JSON line: ms of the whole call, of
the recurrence and of the projection, each through its own entry,
microseconds a step of the recurrence, the card's name and power limit.

``--proj`` times the projection alone instead (bf16, at each shape, in
one process): the wgmma kernel (``csrc/proj_sm90.cuh``), ``torch.addmm``
on the same bf16 operands (``proj_library``; the port never calls it)
and the WMMA kernel it replaced (``proj_bf16_kernel``, built with
``csrc/bilstm_fwd.cu``'s ``K1F_WGMMA_PROJECTION`` 0, ``PROJ_WMMA``), each
with its TFLOP/s over the live frames, its share of the bound
(``proj_work``), the kernel's device time (torch.profiler) and the
host time of one call of the wrapper and of addmm (``host_us``). With
``--ablate`` as well, the wgmma kernel with one piece cut or changed at
a time (``PROJ_CUTS``; a cut computes wrong results, only its time
counts).

``--proj --dtype float32`` times the f32 projection instead, at the
milestones' three layer shapes (``k1b_probe.F32_SHAPES``), in one
process: the kernel (``csrc/gemm_f32.cuh``'s ``ring_kernel``), the
kernel it replaced (``proj_f32_kernel``, built with
``csrc/bilstm_fwd.cu``'s ``K1_F32_TILED`` 0, ``k1b_probe.F32_OLD``), its
plain twin and ``torch.addmm`` in f32 (TF32 off), each with its TFLOP/s
and its share of the f32 bound (``proj_work``'s operations at 67
TFLOP/s, or the bytes), and the kernels' device time.

``--ablate`` also builds ``csrc/bilstm_fwd.cu`` with one piece of the
cluster recurrence's step cut at a time (``CUTS``; each such build
computes wrong results, only its time counts) and times the recurrence
of the flagship's layer 0 in f32 and bf16, both forms, with each, in the
same process as the kernel as it is: the time a piece costs is the
difference. Two more builds there are comparisons, not cuts: the cluster
kernel with 48 rows a cluster whatever B is, and ``recur_kernel`` (the
design before the cluster kernel, W_h from L2 every step) in its place.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.ops import bilstm as K
from gluon_e2e_asr_tpu_torch.tools.k1b_probe import (
    F32_CUTS, F32_KERNELS, F32_OLD, F32_SHAPES, PEAK_BF16, PEAK_F32, PEAK_BYTES, SHAPES,
    build_cuts, event_ms, kernel_ms, layer)

# name -> [(text of csrc/bilstm_fwd.cu or of csrc/common.cuh, its
# replacement)]: each cuts one piece of fwd_cluster_kernel's step.
CUTS = {
    "product": [("      for (int j = 0; j < KB; ++j) {",
                 "      for (int j = 0; j < 0; ++j) {")],
    # h' goes to this CTA's own buffer only
    "all-gather": [(
        "        *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, k)) = hv4;",
        "        *reinterpret_cast<float4*>(dst) = hv4;")],
    # a CTA barrier where the cluster barrier ends the step, and one
    # cluster barrier after the loop, so that no CTA exits while another
    # may still store into its shared memory
    "cluster barrier": [
        ("    cluster_arrive();\n    if (unit_live) {",
         "    __syncthreads();\n    if (unit_live) {"),
        ("    cluster_wait();\n  }\n}\n", "  }\n  cluster.sync();\n}\n")],
    "stream loads": [
        ("        if (t < len[r]) {\n          const XT* xr = xd + (size_t)((b0 + row0",
         "        if (false) {\n          const XT* xr = xd + (size_t)((b0")],
    "stream stores": [("        if (b >= B) continue;", "        continue;")],
    # not cuts: the kernel with 48 rows a cluster whatever B is, and
    # recur_kernel, the design before the cluster kernel, on the same
    # inputs (W_h in the other layout, of the same size at these shapes)
    "48 rows a cluster": [("  for (int r = kRowStep; r <= kMaxRows;",
                           "  for (int r = kMaxRows + 1; r <= kMaxRows;")],
    "cluster design (recur_kernel instead)": [
        ("  if (H <= kClusterMaxHidden) {\n    return io.cs",
         "  if (false) {\n    return io.cs")],
}


# The build variant with the WMMA projection in place of the wgmma kernel.
PROJ_WMMA = {"wmma": [("#define K1F_WGMMA_PROJECTION 1",
                       "#define K1F_WGMMA_PROJECTION 0")]}
# name -> [(text of csrc/bilstm_fwd.cu or of a csrc/ header, its
# replacement)]: each cuts or changes one piece of the wgmma projection.
PROJ_CUTS = {
    # the f32 words go in as they are, unrounded
    "no rounding": [("  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s.v[i].x, s.v[i].y);",
                     "  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(s.v[i].x);")],
    "no wgmma": [("        wgmma_m64n256k16_rs(acc, fa[j & 1], db + 2 * j);\n",
                  "")],
    "no stores": [("        tma_store_2d(&out_map, buf, n0 + c * kOutCols, m0 + 64 * wg);\n",
                   "")],
    # the stage's x boxes (f32) or its W_x tile (bf16) not loaded: what
    # the products wait for, by operand
    "no x loads": [
        ("        mbar_expect_tx(full + st, kStageBytes);",
         "        mbar_expect_tx(full + st, kBBytes);"),
        ("          tma_load_2d(s + b * kABoxBytes, &x_map, full + st, k * kBK + b * kBox, m0);\n",
         "")],
    "no W_x loads": [
        ("        mbar_expect_tx(full + st, kStageBytes);",
         "        mbar_expect_tx(full + st, kABoxes * kABoxBytes);"),
        ("        tma_load_2d(s + kABoxes * kABoxBytes, &w_map, full + st, k * kBK, n0);\n",
         "")],
    # not cuts: a ring of 2 stages (whether the products wait on the
    # loads), a ring of 6 stages of 32 k (the same bytes in finer stages),
    # and each tile's stores complete before the next tile
    "2 stages": [("constexpr int kStages = 3;        // the ring",
                  "constexpr int kStages = 2;        // the ring")],
    "6 stages of 32 k": [
        ("constexpr int kBK = 64;           // depth of a stage",
         "constexpr int kBK = 32;           // depth of a stage"),
        ("constexpr int kStages = 3;        // the ring",
         "constexpr int kStages = 6;        // the ring")],
    # the first design's release: a stage freed only once the next
    # stage's first product is issued
    "late release": [
        ("        }\n"
         "      }\n"
         "      // The stage is released as soon as its last product is done, not\n",
         "        } else {\n"
         "          wgmma_wait<1>();\n"
         "          fence_acc(acc);\n"
         "        }\n"
         "        if (j == 0 && k > 0 && leader) mbar_arrive(empty + (i - 1) % kStages);\n"
         "      }\n"
         "      // The stage is released as soon as its last product is done, not\n"),
        ("      wgmma_wait<0>();\n"
         "      fence_acc(acc);\n"
         "      if (leader) mbar_arrive(empty + st);\n"
         "    }\n",
         "    }\n"
         "    wgmma_wait<0>();\n"
         "    fence_acc(acc);\n"
         "    if (args.steps > 0 && leader) mbar_arrive(empty + (i - 1) % kStages);\n")],
    "epilogue not overlapped": [("#define PROJ_OVERLAP_EPILOGUE 1",
                                 "#define PROJ_OVERLAP_EPILOGUE 0")],
}


def proj_work(lens, T: int, D: int, H: int):
    """(operations, bytes) of K1-fwd's projection at one layer: x . W_x,
    its forward half over every frame (the output holds it there) and its
    backward half over the live frames (sum of lens; 0 past them); in, x
    (f32, as the entry takes it), W_x (f32), b_x and lens; out, xg
    [B,T,8H] f32."""
    B = len(lens)
    frames = float(sum(int(n) for n in lens))
    ops = 2.0 * (B * T + frames) * D * 4 * H
    nbytes = (4 * B * T * D + 4 * D * 8 * H + 4 * 8 * H + 4 * B
              + 4 * B * T * 8 * H)
    return ops, nbytes


def proj_bound(lens, T: int, D: int, H: int, peak: float = PEAK_BF16):
    """(ms, "operations" or "bytes"): the least time of the projection on
    the H100, the operations at ``peak`` FLOP/s."""
    ops, nbytes = proj_work(lens, T, D, H)
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def proj_library(x, w_x, b_x, dtype=torch.bfloat16):
    """``torch.addmm`` on the projection's operands in ``dtype`` (x
    [B*T, D], W_x, b_x; bf16: rounded here, outside the timing), out in
    ``dtype`` (f32 with TF32 off, as the caller sets it), no mask. A
    yardstick: the port never calls it."""
    xb = x.to(dtype).reshape(-1, x.shape[-1])
    wb, bb = w_x.to(dtype), b_x.to(dtype)
    return lambda: torch.addmm(bb, xb, wb)


def host_us(fn, n: int = 100) -> float:
    """Mean host microseconds of one call of ``fn`` (the card idle at
    each start): what a call costs the host before its kernels run."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / n * 1e6


def proj(iters: int, dev, card: str, ablate: bool) -> dict:
    """--proj: the projection alone at each shape, bf16, the wgmma
    kernel, addmm and the WMMA variant in one process; with ``ablate`` the
    PROJ_CUTS variants too."""
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "k1f_cuts"), "bilstm_fwd",
                      {**PROJ_WMMA, **(PROJ_CUTS if ablate else {})})
    kernel_lib = _build.load_library("bilstm_fwd")
    bf = torch.bfloat16
    results = {}
    for name, B, T, D, H in SHAPES:
        (x, lens, w_x, b_x, _, _), _ = layer(B, T, D, H, dev)
        run = lambda: K.bilstm_fused_proj_kernel(  # noqa: E731
            x, lens, w_x, b_x, bf)
        libs = {"wgmma": kernel_lib, **cuts}
        ms, device, failed = {}, {}, {}
        try:
            for profile in (False, True):  # all event timings first
                for cut, lib in libs.items():
                    if cut in failed:
                        continue
                    _build._libs["bilstm_fwd"] = lib
                    try:
                        if profile:
                            device[cut] = kernel_ms(run, "proj")
                        else:
                            ms[cut] = event_ms(run, iters)
                    except RuntimeError as e:  # a variant that fails to launch
                        failed[cut] = str(e)
        finally:
            _build._libs["bilstm_fwd"] = kernel_lib
        if "wgmma" in failed:
            raise RuntimeError(failed["wgmma"])
        ms["addmm"] = event_ms(proj_library(x, w_x, b_x), iters)
        host = {"wgmma": host_us(run),
                "addmm": host_us(proj_library(x, w_x, b_x))}
        lens_h = lens.cpu().tolist()
        ops, _ = proj_work(lens_h, T, D, H)
        bound_ms, bound_by = proj_bound(lens_h, T, D, H)
        rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
               "compute_dtype": "bfloat16",
               **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_tflops_live": ops / v / 1e9 for k, v in ms.items()},
               "bound_ms": bound_ms, "bound_by": bound_by,
               **{f"{k}_share_of_bound": bound_ms / v for k, v in ms.items()},
               "kernel_ms": device, "host_us": host, "failed": failed,
               "card": card}
        results[name] = rec
        print(json.dumps(rec), flush=True)
    return results


def proj_f32(iters: int, dev, card: str, ablate: bool) -> dict:
    """--proj --dtype float32: the f32 projection alone at F32_SHAPES,
    ring_kernel, the first kernel (F32_OLD), its plain twin and addmm in
    f32, in one process; with ``ablate`` the F32_CUTS variants too."""
    variants = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "k1f_cuts"), "bilstm_fwd",
                          {**F32_OLD, **(F32_CUTS if ablate else {})})
    kernel_lib = _build.load_library("bilstm_fwd")
    f32 = torch.float32
    results = {}
    for name, B, T, D, H in F32_SHAPES:
        (x, lens, w_x, b_x, _, _), _ = layer(B, T, D, H, dev)
        run = lambda: K.bilstm_fused_proj_kernel(  # noqa: E731
            x, lens, w_x, b_x, f32)
        ms, device = {}, {}
        try:  # every event timing before the first profiler run
            for profile in (False, True):
                for variant, lib in (("kernel", kernel_lib),
                                     *variants.items()):
                    _build._libs["bilstm_fwd"] = lib
                    if profile:
                        device[variant] = kernel_ms(run, F32_KERNELS)
                    else:
                        ms[variant] = event_ms(run, iters)
        finally:
            _build._libs["bilstm_fwd"] = kernel_lib
        ms["plain"] = event_ms(lambda: K.bilstm_fused_proj_plain(
            x, lens, w_x, b_x, f32), iters)
        ms["addmm"] = event_ms(proj_library(x, w_x, b_x, f32), iters)
        lens_h = lens.cpu().tolist()
        ops, _ = proj_work(lens_h, T, D, H)
        bound_ms, bound_by = proj_bound(lens_h, T, D, H, PEAK_F32)
        rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
               "compute_dtype": "float32", "live_frames": sum(lens_h),
               **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_tflops": ops / v / 1e9 for k, v in ms.items()},
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
    p.add_argument("--proj", action="store_true")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="--proj: the bf16 (wgmma) or the f32 route")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1f_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    _build.build_all(["bilstm_fwd"])
    if args.proj:
        if args.dtype == "float32":
            return proj_f32(args.iters, dev, card, args.ablate)
        return proj(args.iters, dev, card, args.ablate)
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "k1f_cuts"), "bilstm_fwd",
                      CUTS) if args.ablate else {}
    results = {}
    for name, B, T, D, H in SHAPES:
        (x, lens, w_x, b_x, w_hf, w_hb), _ = layer(B, T, D, H, dev)
        for cd in (torch.float32, torch.bfloat16):
            xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False),
                           -1).contiguous()
            xg_train = xg.clone()  # overwritten with the activations
            for train in (False, True):
                whole = event_ms(lambda: K.bilstm_fused_kernel(
                    x, lens, w_x, b_x, w_hf, w_hb, cd, with_cell=train),
                    args.iters)
                recur = lambda: K.bilstm_fused_fwd_recur_kernel(  # noqa: E731
                    xg_train if train else xg, lens, w_hf, w_hb, cd, train)
                r_ms = event_ms(recur, args.iters)
                p_ms = event_ms(lambda: K.bilstm_fused_proj_kernel(
                    x, lens, w_x, b_x, cd), args.iters)
                rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
                       "compute_dtype": str(cd).split(".")[1],
                       "form": "training" if train else "serving",
                       "whole_ms": whole, "recur_ms": r_ms,
                       "projection_ms": p_ms,
                       "recur_us_per_step": r_ms * 1e3 / T,
                       "cluster": H <= K.CLUSTER_MAX_HIDDEN, "card": card}
                if cuts and name == SHAPES[0][0]:
                    kernel_lib = _build._libs["bilstm_fwd"]
                    rec["recur_us_per_step_without"] = {}
                    for cut, lib in cuts.items():
                        _build._libs["bilstm_fwd"] = lib
                        try:
                            rec["recur_us_per_step_without"][cut] = \
                                event_ms(recur, args.iters) * 1e3 / T
                        finally:
                            _build._libs["bilstm_fwd"] = kernel_lib
                results[(name, rec["compute_dtype"], rec["form"])] = rec
                print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
