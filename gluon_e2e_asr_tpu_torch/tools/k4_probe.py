"""K4-fwd and K4-bwd alone on one card, in each attention mode, at the
location-aware flagship's width (``configs/flagship_bf16.yaml``: B=96,
D=640, E=256, H=A=320, V=32, C=10 channels of a width-100 filter).

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.k4_probe [--ablate]

For each (T', L) of the 4.0 s bucket (100, 81) and of bench.py's shape
(320, 97), each mode and each compute dtype, one JSON line: the largest
difference from the plain version of every output and cotangent over its
largest magnitude, and the kernels' times (CUDA events, mean of 5 runs
after a warm-up). The inputs are seeded: frame counts drawn uniformly
in [1, T'], one row full and one with no frames.

``--ablate`` also builds K4-bwd with one piece of its energy phase cut
at a time (``CUTS``; each such build computes wrong results, only its
time counts) and times each in bf16 beside the kernel as it is, in the
same process: the time a piece costs is the difference.
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
# name -> (text of csrc/las_decoder.cu, its replacement): each cuts one
# piece of K4-bwd's energy phase.
CUTS = {
    "d_enc_proj update": (
        "            float4 d = *dp;\n"
        "            d.x += de[0], d.y += de[1], d.z += de[2], d.w += de[3];\n"
        "            *dp = d;\n", ""),
    "feature product": (
        "for (int j = 0; j < 4; ++j) x[j] += fl[j];",
        "for (int j = 0; j < 4; ++j) (void)fl[j];"),
    "dfct sums": (
        "                if (c < C) {\n"
        "                  const float4 l =",
        "                if (false) {\n"
        "                  const float4 l ="),
    "sums over frames": (
        "for (int t = t0; t < min(t1, n_own); ++t) {",
        "for (int t = t0; t < t0; ++t) {"),
    "d_loc_proj sums": (
        "for (int t = t0; t < min(t1, len_s[r]); ++t) {",
        "for (int t = t0; t < t0; ++t) {"),
    "feature convolution": (
        "        loc_feature<WT>(attp, filt_s, C, W, len_s, T, f_s);\n", ""),
    "carry correlation": (
        "        loc_carry<WT>(dfct_s, filt_s, C, W, len_s, T, part, datt_c);\n",
        ""),
}


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


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def build_cuts(out_dir: str):
    """name -> the library of csrc/las_decoder.cu with that cut, one nvcc
    each, all started together."""
    with open(os.path.join(_build.SRC_DIR, "las_decoder.cu")) as f:
        src = f.read()

    def build(name):
        old, new = CUTS[name]
        if src.count(old) != 1:
            raise RuntimeError(f"cut {name!r}: its text is not in the source once")
        d = os.path.join(out_dir, name.replace(" ", "_").replace(",", ""))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "las_decoder.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        lib = os.path.join(d, "liblas_decoder.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               _build.SRC_DIR, "-o", lib, path],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"cut {name!r}: nvcc failed\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(CUTS)) as pool:
        paths = dict(zip(CUTS, pool.map(build, CUTS)))
    return {name: ctypes.CDLL(p) for name, p in paths.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ablate", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernel_lib = _build.load_library("las_decoder")
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "k4_probe")) if args.ablate else {}
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
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
                       "rel_err": errs,
                       "fwd_ms": time_ms(lambda: K.las_decoder_fwd_kernel(*fargs, filt)),
                       "bwd_ms": time_ms(lambda: K.las_decoder_bwd_kernel(*bargs))}
                if cuts and kind != "dot" and cd == torch.bfloat16:
                    rec["bwd_ms_without"] = {}
                    for name, lib in cuts.items():
                        _build._libs["las_decoder"] = lib
                        try:
                            rec["bwd_ms_without"][name] = time_ms(
                                lambda: K.las_decoder_bwd_kernel(*bargs))
                        finally:
                            _build._libs["las_decoder"] = kernel_lib
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
