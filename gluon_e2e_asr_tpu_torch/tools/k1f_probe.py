"""K1-fwd alone on the card: the whole call and its recurrence.

Times ``ops/bilstm.py::bilstm_fused_kernel`` (the projection and the
recurrence) and ``bilstm_fused_fwd_recur_kernel`` (the recurrence alone,
over the same projection) by CUDA events at the flagship's three layer
shapes (B=96, H=320, the 4.0 s bucket: T 398/199/100) and milestone 2's
(B=16, H=256), f32 and bf16, in the serving and the training form, on
seeded inputs. Run from the root of a checkout on a machine with the card
and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.k1f_probe [--iters 10] [--ablate]

Each shape, dtype and form prints one JSON line: ms of the whole call and
of the recurrence, the projection as their difference, microseconds a
step of the recurrence, the card's name and power limit.

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

import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.ops import bilstm as K
from gluon_e2e_asr_tpu_torch.tools.k1b_probe import (
    SHAPES, build_cuts, event_ms, layer)

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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--ablate", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1f_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    _build.build_all(["bilstm_fwd"])
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
                rec = {"shape": name, "B": B, "T": T, "D": D, "H": H,
                       "compute_dtype": str(cd).split(".")[1],
                       "form": "training" if train else "serving",
                       "whole_ms": whole, "recur_ms": r_ms,
                       "projection_ms": whole - r_ms,
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
