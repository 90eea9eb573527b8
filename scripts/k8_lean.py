"""The lean of K8's outputs (csrc/recompute_sweeps.cu ext2_matvec_kernel) on
synthetic features, at 32, 64, 96 and 128 feature lanes, on one CUDA card.

    python3 scripts/k8_lean.py

For normal(0, 0.3) features of 25, 49, 81 and 121 lanes (the 32-, 64-,
96- and 128-lane kernels; past 64 the entries come from kb_pair, not the
table) at p_pad 1024 and 4096 against 33024 and 77056 columns, it runs
K8 and its plain version on the same aug layouts and prints, as the share
of outputs below their reference (ties left out, chip_smoke.signed_stats'
sense): the kernel's u against the plain u; the kernel's s against the
plain s; the kernel's u against the f64 sum of the same bf16 tile entries
times the kernel's own s (the lean of u's accumulation alone); the plain
u against the f64 sum with the plain s; the kernel's s and the plain s
against the f64 evaluation of s on the same bf16 tile entries
(chip_smoke.ext2_recompute_f64: bf16 t2, kbt and s in f64), the reference
chip_smoke.py holds K8's s to. Each case runs twice: with sample rows
drawn apart from the columns (no row meets its own features), and with the
sample rows equal to the first p columns, so that every row holds its own
column, whose entry is the largest of the row (d2 = 0 in f64, k = 1): the
probe of K5 f32's low lean (scripts/f32_matvec_designs.py), where those
entries lean one way. Prints the card line and one JSON line a case.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASES = [(25, 1000, 33024), (25, 4000, 77056), (25, 1000, 77056),
         (49, 1000, 33024), (49, 4000, 77056), (49, 1000, 77056),
         (81, 4000, 77056), (81, 1000, 77056),
         (121, 4000, 77056), (121, 1000, 77056)]
CHUNK = 16384


def share_below(got, ref):
    """(share of got below ref, sign(ref)-signed, ties left out; entries)."""
    d = (got.double() - ref.double()) * torch.sign(ref.double())
    d = d[d != 0]
    return float((d < 0).double().mean()), d.numel()


def u_f64(k79, fa, f_t, s):
    """sum_j k_j s_j in f64 over the plain version's bf16 tile entries."""
    u = torch.zeros(fa.shape[0], dtype=torch.float64, device=fa.device)
    for j in range(0, f_t.shape[1], CHUNK):
        kb = k79._tile_plain(fa, f_t[:, j:j + CHUNK], True)
        u += kb.double() @ s[j:j + CHUNK].double()
    return u


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k8_lean: needs a CUDA card")
    from graphlap_tpu_torch.ops import cuda_recompute as k79
    from graphlap_tpu_torch.ops import recompute_layout as rl

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_checks", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for (d, p, n), own in ((c, own) for c in CASES for own in (False, True)):
        rng = np.random.default_rng(p + n)
        tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
        fa_raw, fb_raw = rng.normal(0, 0.3, (p, d)), rng.normal(0, 0.3, (n, d))
        if own:
            fa_raw = fb_raw[:p]
        fa_aug, f_t = rl.aug_pads(tt(fa_raw), tt(fb_raw), n)
        bm = tt(rng.random(n) > 0.2)
        t2 = torch.zeros((2, fa_aug.shape[0]), device=dev)
        t2[:, :p] = tt(rng.uniform(0.5, 1.5, (2, p)))
        u, s = k79.ext2_matvec_cuda(fa_aug, f_t, t2, bm, True)
        u_p, s_p = k79.ext2_matvec_plain(fa_aug, f_t, t2, bm, True)
        s64 = cs.ext2_recompute_f64(fa_aug, f_t, t2, bm, True)[1]
        print(json.dumps(dict(
            lanes=f_t.shape[0], features=d, p_pad=fa_aug.shape[0], n=n,
            rows_are_columns=own,
            u_vs_plain=share_below(u[:p], u_p[:p]),
            s_vs_plain=share_below(s, s_p),
            u_vs_f64_own_s=share_below(u[:p], u_f64(k79, fa_aug, f_t, s)[:p]),
            plain_u_vs_f64=share_below(u_p[:p],
                                       u_f64(k79, fa_aug, f_t, s_p)[:p]),
            s_vs_f64=share_below(s, s64), plain_s_vs_f64=share_below(s_p, s64))),
              flush=True)


if __name__ == "__main__":
    main()
