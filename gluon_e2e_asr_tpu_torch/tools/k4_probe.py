"""K4-fwd and K4-bwd alone on one card, in each attention mode, at the
location-aware flagship's width (``configs/flagship_bf16.yaml``: B=96,
D=640, E=256, H=A=320, V=32, C=10 channels of a width-100 filter).

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.k4_probe [--ablate] [--phases]
        [--only fwd|bwd]

For each (T', L) of the 4.0 s bucket (100, 81) and of bench.py's shape
(320, 97), each mode and each compute dtype, one JSON line: the largest
difference from the plain version of every output and cotangent over its
largest magnitude, the kernels' times (CUDA events, mean of 5 runs after
a warm-up: the wrapper's host work included), each direction's device
time (torch.profiler: its kernels alone), and both again in the design
before its cluster kernel (the build variants ``K4F_CLUSTER 0``:
``fwd_kernel``, and ``K4B_CLUSTER 0``: ``bwd_kernel``, two rows a block)
in the same process, and each direction at half the batch (48 rows: a
second wave of clusters would show as a time that does not fall). The
inputs are seeded: frame counts drawn uniformly in [1, T'], one row full
and one with no frames. ``--only`` times one direction (the other still
runs: K4-bwd reads K4-fwd's outputs).

``--ablate`` also builds each cluster kernel with one piece cut at a time
(``FWD_CUTS``: each of the forward's three exchanges, the cluster
barriers, both products, the scores, the context, the logits and loc's
feature; ``CUTS``: the backward's exchanges, barriers, products, the
row's attention gradient and the pieces of the energy phase; each such
build computes wrong results, only its time counts) and times each in
bf16 beside the kernel as it is, in the same process: the time a piece
costs is the difference. ``--phases`` builds the variants that count SM
cycles by phase (``K4F_TIMING 1``, ``K4B_TIMING 1``: thread 0 of the
first CTA, after each phase's barrier) and gives each phase's share of a
step and its microseconds a step (the share of the kernel's own time).
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
from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

B, D, E, H, A, V, C, W = 96, 640, 256, 320, 320, 32, 10, 100
SHAPES = ((100, 81), (320, 97))
# The build variants of the designs before the cluster kernels, and the
# ones that count cycles by phase.
FWD_OLD_DESIGN = ("#define K4F_CLUSTER 1", "#define K4F_CLUSTER 0")
FWD_TIMING = ("#define K4F_TIMING 0", "#define K4F_TIMING 1")
OLD_DESIGN = ("#define K4B_CLUSTER 1", "#define K4B_CLUSTER 0")
TIMING = ("#define K4B_TIMING 0", "#define K4B_TIMING 1")
# fwd_cluster_kernel's phases, in the order K4F_PHASE counts them
FWD_PHASES = ("embeddings", "gate product", "cells", "exchange 1",
              "query product", "query sums + exchange 2",
              "h copy / feature (loc)", "scores", "softmax", "context",
              "logits", "argmax + token", "exchange 3")
# bwd_cluster_kernel's phases, in the order K4B_PHASE counts them
PHASES = ("inputs", "head product", "head sums + exchange 1",
          "attention gradient", "softmax backward",
          "dqb (dot) / carry and dqb (add, loc)", "exchange 2",
          "query product", "cells", "exchange 3", "gates product",
          "gates sums", "feature and query (add, loc)",
          "energy chunks: frames", "energy chunks: sums over frames (loc)",
          "energy chunks: d_loc_proj sums (loc) / sums over frames (add)")
# name -> (text of csrc/las_decoder.cu, its replacement, the times the
# text occurs): each cuts one piece of the cluster kernel (the energy
# phase's pieces are energy_bwd's, which bwd_kernel shares).
CUTS = {
    # each exchange's stores into the other CTAs (exchange 1: into this
    # CTA's own slot instead)
    "exchange 1 (dctx)": (
        "          *cluster.map_shared_rank(slot1 + d, r) = rnd<WT>(x);",
        "          slot1[d] = rnd<WT>(x);", 1),
    "exchange 2 (dqb)": (
        "for (int k = tid; k < (kCl - 1) * A; k += nt) {",
        "for (int k = tid; k < 0; k += nt) {", 1),
    "exchange 3 (dgates)": (
        "for (int k = tid; k < (kCl - 1) * mine; k += nt) {",
        "for (int k = tid; k < 0; k += nt) {", 1),
    # the three split cluster barriers of a step as CTA barriers (the
    # forward's three too: each build times one direction)
    "cluster barriers": (
        "    port::cluster_arrive();\n    port::cluster_wait();\n",
        "    __syncthreads();\n", 6),
    "head product": ("    cl_product<WT>(vh, V, wh, NH / 4, Sh, part);\n", "", 1),
    "query product": ("    cl_product<WT>(slot2, A, wq, HU / 4, Sq, part);\n", "", 1),
    "gates product": ("    cl_product<WT>(slot3, H4, wg, NX / 4, Sg, part);\n", "", 1),
    "attention gradient": (
        "    frame_dots_row<WT>(enc, D, slot1, n, T, sc);\n", "", 1),
    # the energy phase (add, loc)
    "d_enc_proj update": (
        "        float4 d = *dp;\n"
        "        d.x += de[0], d.y += de[1], d.z += de[2], d.w += de[3];\n"
        "        *dp = d;\n", "", 1),
    "feature product": (
        "for (int j = 0; j < 4; ++j) x[j] += fl[j];",
        "for (int j = 0; j < 4; ++j) (void)fl[j];", 1),
    "dfct sums": (
        "            if (c < C) {\n"
        "              const float4 l =",
        "            if (false) {\n"
        "              const float4 l =", 1),
    "sums over frames": (
        "    if (own) {\n      int t = t0;", "    if (false) {\n      int t = t0;", 1),
    "d_loc_proj sums": (
        "          int t = t0;\n          if constexpr (NR == 1) {\n"
        "            // Four frames",
        "          int t = t1;\n          if constexpr (NR == 1) {\n"
        "            // Four frames", 1),
    "feature convolution": (
        "        loc_feature_row<WT>(attp, filt_s, C, W, n, T, f_s);\n", "", 1),
    "carry correlation": (
        "        loc_carry_row<WT>(dfct_s, filt_s, C, W, n, T, part, datt_c);\n",
        "", 1),
}
# The same for fwd_cluster_kernel.
FWD_CUTS = {
    # each exchange's stores into the other CTAs (exchanges 2 and 3: into
    # this CTA's own slots instead)
    "exchange 1 (h)": (
        "for (int k = tid; k < (kCl - 1) * 2 * HU; k += nt) {",
        "for (int k = tid; k < 0; k += nt) {", 1),
    "exchange 2 (q)": (
        "      *cluster.map_shared_rank(qs + m, r) = v;",
        "      qs[m] = v;", 1),
    "exchange 3 (ctx, token)": (
        "for (int k = tid; k < kCl * D; k += nt) {",
        "for (int k = tid; k < D; k += nt) {", 1),
    "cluster barriers": CUTS["cluster barriers"],
    "gate product": ("    cl_product<WT>(gcur, KX, wg, HU, Sg, part);\n", "", 1),
    "query product": (
        "    cl_product<WT>(gnext + (size_t)(E + D) * 4, H, wq, AU / 4, Sq, "
        "part, KG);\n", "", 1),
    "scores (dot)": (
        "      frame_dots_row<WT>(encp, A, qs, n, T, sc, a.scale);\n", "", 1),
    "energies (add, loc)": (
        "      frame_energies<WT, MODE == kLoc, 1>(encp, 0, A, qs, v_s, "
        "locp_s, f_s,\n", "      if (false) frame_energies<WT, MODE == kLoc, "
        "1>(encp, 0, A, qs, v_s, locp_s, f_s,\n", 1),
    "context": ("    gemv_rows<WT, 1>(sc, T, len_s, enc, 0, D, part);\n", "", 1),
    "logits": ("    gemv_partials<WT, 1>(hc, 0, HD, w_out, V, part);\n", "", 1),
    "feature (loc)": (
        "\n      loc_feature_row<WT>(attp, filt_s, C, W, n, T, f_s);\n", "\n", 1),
}
# the cuts that apply to some modes only
FWD_MODE_CUTS = {"scores (dot)": ("dot",), "energies (add, loc)": ("add", "loc"),
                 "feature (loc)": ("loc",)}
ENERGY_CUTS = ("d_enc_proj update", "feature product", "dfct sums",
               "sums over frames", "d_loc_proj sums", "feature convolution",
               "carry correlation")


def case(dev, T: int, L: int, kind: str, seed: int = 4):
    """(tokens, coins, enc, enc_proj, enc_len, weights) and the filter
    [W,1,C] (None unless loc), seeded with numpy."""
    rng = np.random.RandomState(seed)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    enc_len = rng.randint(1, T + 1, size=B).astype(np.int32)
    enc_len[0], enc_len[-1] = T, 0
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    enc = torch.tanh(f(B, T, D))
    energy = kind != "dot"
    zeros = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    w = K.Weights(f(V, E) / np.sqrt(E), f(E + D, 4 * H) / np.sqrt(E + D),
                  f(4 * H) * 0.1, f(H, 4 * H) / np.sqrt(H),
                  f(H, A) / np.sqrt(H),
                  f(A) * 0.1 if energy else zeros(A),
                  f(A, 1) / np.sqrt(A) if energy else zeros(A, 1),
                  f(C, A) / np.sqrt(C) if kind == "loc" else zeros(1, A),
                  f(H + D, V) / np.sqrt(H + D), f(V) * 0.1)
    enc_proj = enc @ (f(D, A) / np.sqrt(D))
    filt = f(W, 1, C) / np.sqrt(W) if kind == "loc" else None
    coins = torch.zeros(B, L, dtype=torch.bool, device=dev)
    return (torch.from_numpy(tokens).to(dev), coins, enc, enc_proj,
            torch.from_numpy(enc_len).to(dev), w), filt


def time_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# K4's kernels by name: K4-fwd (either design), K4-bwd's sweep (either
# design) and dot's d_enc_proj
FWD_KERNELS = ("fwd_cluster_kernel", "fwd_kernel")
SWEEP_KERNELS = ("bwd_cluster_kernel", "bwd_kernel")
BWD_KERNELS = SWEEP_KERNELS + ("d_encp_kernel",)


def device_ms(fn, keys=BWD_KERNELS, n: int = 5) -> float:
    """The device time per call of fn's kernels whose names hold one of
    ``keys`` (torch.profiler), after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if any(k in evt.key for k in keys):
            us += getattr(evt, "self_device_time_total",
                          getattr(evt, "self_cuda_time_total", 0))
    return us / 1e3 / n


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def build_variants(out_dir: str, variants):
    """name -> the library of csrc/las_decoder.cu with that variant's
    (text, replacement, count), one nvcc each, all started together."""
    with open(os.path.join(_build.SRC_DIR, "las_decoder.cu")) as f:
        src = f.read()

    def build(name):
        old, new, count = variants[name]
        if src.count(old) != count:
            raise RuntimeError(f"variant {name!r}: its text is not in the "
                               f"source {count} times")
        d = os.path.join(out_dir, "".join(c if c.isalnum() else "_" for c in name))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "las_decoder.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        lib = os.path.join(d, "liblas_decoder.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               _build.SRC_DIR, "-o", lib, path],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(build, variants)))
    return {name: ctypes.CDLL(p) for name, p in paths.items()}


def time_with(lib, fn, route=None, timer=time_ms, which="bwd") -> float:
    """fn's time (``timer``) with ``lib`` in place of the las_decoder
    library (and ``route`` as the route of direction ``which``: the old
    design's weight layout)."""
    name = f"{which}_route"
    saved, saved_route = _build._libs["las_decoder"], getattr(K, name)
    _build._libs["las_decoder"] = lib
    if route is not None:
        setattr(K, name, lambda *a: route)
    try:
        return timer(fn)
    finally:
        _build._libs["las_decoder"] = saved
        setattr(K, name, saved_route)


def phases(lib, fn, L: int, which="bwd"):
    """Each phase's share of the cluster kernel's counted cycles in one
    launch (the variant ``lib``; ``which``: fwd_cluster_kernel or
    bwd_cluster_kernel), and its microseconds a step at the kernel's
    device time in that variant."""
    names, keys = (FWD_PHASES, FWD_KERNELS) if which == "fwd" else (
        PHASES, SWEEP_KERNELS)
    read = getattr(lib, f"las_decoder_{which}_phase_cycles")
    read.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * len(names))()
    time_with(lib, fn)  # warm-up; then clear
    read(out)
    saved = _build._libs["las_decoder"]
    _build._libs["las_decoder"] = lib
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _build._libs["las_decoder"] = saved
    rc = read(out)
    if rc != 0:
        raise RuntimeError(f"reading the phase cycles failed: {rc}")
    cycles = list(out)
    total = sum(cycles)
    ms = time_with(lib, fn, timer=lambda f: device_ms(f, keys))
    shares = {name: {"share": c / total, "us_per_step": c / total * ms * 1e3 / L}
              for name, c in zip(names, cycles)}
    # the first CTA's counted cycles over the sweep's device time: the SM
    # clock it ran at
    shares["sm_mhz"] = total / (ms * 1e3)
    return shares


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--phases", action="store_true")
    p.add_argument("--only", choices=("fwd", "bwd"))
    args = p.parse_args(argv)
    fwd_on, bwd_on = args.only != "bwd", args.only != "fwd"
    if not torch.cuda.is_available():
        raise SystemExit("k4_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.load_library("las_decoder")
    variants = {}
    if fwd_on:
        variants["fwd old design"] = (*FWD_OLD_DESIGN, 1)
        if args.ablate:
            variants.update((f"fwd {k}", v) for k, v in FWD_CUTS.items())
        if args.phases:
            variants["fwd phases"] = (*FWD_TIMING, 1)
    if bwd_on:
        variants["old design"] = (*OLD_DESIGN, 1)
        if args.ablate:
            variants.update(CUTS)
        if args.phases:
            variants["phases"] = (*TIMING, 1)
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "k4_probe"), variants)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": card}), flush=True)
    for T, L in SHAPES:
        for kind in K.ATT_KINDS:
            for cd in (torch.float32, torch.bfloat16):
                (tokens, coins, enc, encp, lens, w), filt = case(dev, T, L, kind)
                fargs = (tokens, coins, enc, encp, lens, w, cd, kind)
                band = None if filt is None else K.build_loc_band_cmajor(filt, T)
                logits, resid, extras = K.las_decoder_fwd_kernel(*fargs, filt)
                ref, ref_resid = K.las_decoder_fwd_plain(*fargs, band)
                dl = torch.from_numpy(np.random.RandomState(7).randn(
                    B, L, V).astype(np.float32) * 0.05).to(dev)
                bargs = (dl, resid, extras, enc, encp, lens, w, cd, kind, filt)
                got = K.las_decoder_bwd_kernel(*bargs)
                want = K.las_decoder_bwd_plain(dl, resid, enc, encp, lens, w,
                                               cd, kind, band)
                errs = {"logits": rel(logits, ref)}
                errs.update((n, rel(a, b)) for n, a, b in zip(
                    ("h", "c", "att", "ctx"), resid[:4], ref_resid[:4]))
                errs.update((n, rel(got[n], want[n])) for n in want
                            if want[n] is not None)
                rec = {"T": T, "L": L, "kind": kind, "compute_dtype": str(cd),
                       "rel_err": errs}
                if fwd_on:
                    rec.update(time_fwd(libs, fargs, filt, args, kind, cd, L))
                if bwd_on:
                    rec.update(time_bwd(libs, bargs, args, kind, cd, L))
                print(json.dumps(rec), flush=True)


def _half(t):
    return t[:B // 2] if isinstance(t, torch.Tensor) else t


def time_fwd(libs, fargs, filt, args, kind, cd, L):
    """K4-fwd's times: the cluster kernel and the two-rows design in this
    process, CUDA events and device time; at half the batch; by phase
    and without each piece where asked."""
    fn = K.las_decoder_fwd_kernel
    n = fn.cluster_launches
    fwd = lambda: fn(*fargs, filt)  # noqa: E731
    dev = lambda f: device_ms(f, FWD_KERNELS)  # noqa: E731
    old = libs["fwd old design"]
    rec = {"fwd_ms": time_ms(fwd),
           "fwd_ms_old_design": time_with(old, fwd, "rows", which="fwd"),
           "fwd_ms_again": time_ms(fwd),
           "fwd_device_ms": dev(fwd),
           "fwd_device_ms_old_design": time_with(old, fwd, "rows", dev, "fwd")}
    rec["fwd_cluster_launches"] = fn.cluster_launches - n
    half = tuple(_half(t) for t in fargs)
    rec["fwd_ms_half_batch"] = time_ms(lambda: fn(*half, filt))
    if args.phases:
        rec["fwd_phases"] = phases(libs["fwd phases"], fwd, L, "fwd")
    if args.ablate and cd == torch.bfloat16:
        rec["fwd_ms_without"] = {
            name: time_with(libs[f"fwd {name}"], fwd) for name in FWD_CUTS
            if kind in FWD_MODE_CUTS.get(name, K.ATT_KINDS)}
    return rec


def time_bwd(libs, bargs, args, kind, cd, L):
    """K4-bwd's times, as time_fwd's."""
    n = K.las_decoder_bwd_kernel.cluster_launches
    bwd = lambda: K.las_decoder_bwd_kernel(*bargs)  # noqa: E731
    rec = {"bwd_ms": time_ms(bwd),
           "bwd_ms_old_design": time_with(libs["old design"], bwd, "rows")}
    rec["bwd_ms_again"] = time_ms(bwd)
    rec["bwd_device_ms"] = device_ms(bwd)
    rec["bwd_device_ms_old_design"] = time_with(
        libs["old design"], bwd, "rows", device_ms)
    rec["bwd_cluster_launches"] = K.las_decoder_bwd_kernel.cluster_launches - n
    dl, resid, extras, enc, encp, lens = bargs[:6]
    half = (_half(dl), tuple(map(_half, resid)), tuple(map(_half, extras)),
            _half(enc), _half(encp), _half(lens), *bargs[6:])
    rec["bwd_ms_half_batch"] = time_ms(lambda: K.las_decoder_bwd_kernel(*half))
    if args.phases:
        rec["phases"] = phases(libs["phases"], bwd, L)
    if args.ablate and cd == torch.bfloat16:
        rec["bwd_ms_without"] = {
            name: time_with(libs[name], bwd) for name in CUTS
            if kind != "dot" or name not in ENERGY_CUTS}
    return rec


if __name__ == "__main__":
    main()
