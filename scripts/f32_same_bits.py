"""Whether the f32-layout and coordinate kernels of this checkout give the
same bits as another checkout's at 4, 28, 52, 84 and 124 live lanes (32-
to 128-lane layouts), on one CUDA card.

    python3 scripts/f32_same_bits.py --parent DIR

DIR is another checkout (for example the parent commit unpacked with
``git archive`` into a git-ignored directory). The kernels: K7 f32
(``kb_strip_cuda``), K8 f32's tile entries (``ext2_matvec_cuda`` with t2
one-hot on a sample row i and bm = 1: kbt_r = kbt_c = k_ij plus exact
zeros, so s_j = 1 / sqrt(max(k_ij^2, 1e-30)) is the row's entries, exact
down to k 1e-15; its u and its sums of many entries run in another order
by design since the register-tiled kernel), K9 f32
(``finish_colstats_cuda``), K10 f32 (``colstats_v_cuda``), the coordinate
K5/K6's tile entries (``matvec_cuda`` / ``rmatvec_cuda`` with ``coords``
and a one-hot vector, which write a tile column or row exactly: each entry
plus exact zeros; their sums of many entries run in another order by
design since the register-tiled kernel) and K1's coordinate cross
(``affinity_strip_cuda`` with ``coords``, both stores), each through its
checkout's own wrapper and library, on the same inputs (K7 also at 131
column tiles, and K1 also at 300 x 65499, rows and pixels ragged):
features as the bilateral recipes build them (d - 2 value lanes, then
row / 8 and col / 8 of a 2048 x 4096 image, sample rows 4000, 65536
columns, seeded), d = 3 (the gaussian bilateral recipe, 4 live lanes), d
= 27 (NLM 5 x 5 with the coordinates, 28), d = 51, 83 and 123 (NLM 7 x
7, 9 x 9 and 11 x 11 with them, 52 of 64, 84 of 96, 124 of 128). The
other checkout runs in a
child process (it builds its own library under its own build/), which
writes its outputs to build/f32_same_bits/; this process compares them
with its own. Prints the card line and one JSON line: for each kernel and
depth, whether the outputs are equal bit for bit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "f32_same_bits"
DEPTHS = (3, 27, 51, 83, 123)
# the coordinate K5's tile columns and K6's and K8's tile rows compared (a
# one-hot v, t or t2 each): spread over the pixels and over the live
# sample rows
COLS = (0, 777, 12345, 40000, 65535)
ROWS = (0, 5, 1234, 2500, 3999)
# K1's ragged shape (sample rows not a multiple of the store kernel's 128,
# pixels not of its 128-column tile) and K7's 131 column tiles
RAGGED = (300, 65499)
K7_TILES = 131


def inputs(d: int, dev, p: int = 4000, n: int = 65536, seed: int = 1) -> dict:
    """The bilateral layouts of d raw lanes (a 32- to 128-lane layout) and
    the kernels' vectors, from a seeded generator."""
    rng = np.random.default_rng(seed + d)

    def feats(k):
        rc = np.stack([rng.integers(0, 2048, k) / 8.0,
                       rng.integers(0, 4096, k) / 8.0], axis=1)
        return np.concatenate([rng.uniform(0, 5, (k, d - 2)), rc],
                              axis=1).astype(np.float32)
    fa3 = feats(p)
    base = fa3[rng.integers(0, p, n)]
    jit = np.concatenate([rng.uniform(-0.5, 0.5, (n, d - 2)) / np.sqrt(d - 2),
                          rng.integers(-32, 33, (n, 2)) / 8.0], axis=1)
    fp3 = (base + jit).astype(np.float32)
    p_pad = -(-p // 512) * 512
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fd = -(-d // 32) * 32
    fa = torch.zeros((p_pad, fd), device=dev)
    fa[:p, :d] = t(fa3)
    f_t = torch.zeros((fd, n), device=dev)
    f_t[:d] = t(fp3.T.copy())
    pos = lambda *s: t(rng.uniform(0.5, 1.5, s))  # noqa: E731
    t2 = torch.zeros((2, p_pad), device=dev)
    t2[:, :p] = pos(2, p)
    tv = torch.zeros(p_pad, device=dev)
    tv[:p] = pos(p)
    gr = torch.zeros((p_pad, 64), device=dev)
    gr[:p, :50] = t(rng.normal(0, 0.02, (p, 50)))
    bm = t(rng.random(n) > 0.1)
    return dict(fa=fa, f_t=f_t, t2=t2, tv=tv, gr=gr, bm=bm, cols=pos(n),
                s_pre=pos(n) * bm, y=pos(n), v=pos(n),
                na=torch.sum(fa * fa, dim=1), nb=torch.sum(f_t * f_t, dim=0),
                a3=fa[:512, :d].contiguous(), b3=f_t[:d, :1 << 16].T.contiguous(),
                a3r=fa[:RAGGED[0], :d].contiguous(),
                b3r=f_t[:d, :RAGGED[1]].T.contiguous(), live=-(-d // 4) * 4)


def one_hot(n: int, at, dev) -> list:
    """The unit vectors of length n at the positions ``at``."""
    out = []
    for i in at:
        e = torch.zeros(n, device=dev)
        e[i] = 1.0
        out.append(e)
    return out


def run(dev) -> dict:
    """{case: output tensors} through the importable graphlap_tpu_torch."""
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    out = {}
    for d in DEPTHS:
        x = inputs(d, dev)
        fa, f_t, lv = x["fa"], x["f_t"], x["live"]
        cases = {
            "kb_strip_f32": lambda: k79.kb_strip_cuda(
                fa, f_t[:, :16384].contiguous(), x["cols"][:16384], False, lv),
            "ext2_matvec_f32 tile rows (s)": lambda: tuple(
                k79.ext2_matvec_cuda(fa, f_t, torch.stack([e, e]),
                                     torch.ones(f_t.shape[1], device=dev),
                                     False, lv)[1]
                for e in one_hot(fa.shape[0], ROWS, dev)),
            "finish_colstats_f32": lambda: k79.finish_colstats_cuda(
                fa, f_t, x["tv"], x["s_pre"], x["bm"], x["gr"], x["y"],
                x["na"], x["nb"], live=lv),
            "colstats_v_f32": lambda: k79.colstats_v_cuda(
                fa, f_t, x["gr"], x["y"], x["cols"], x["na"], x["nb"],
                live=lv),
            "matvec_coord tile columns": lambda: tuple(
                k56.matvec_cuda(fa, f_t, e, False, lv, True)
                for e in one_hot(f_t.shape[1], COLS, dev)),
            "rmatvec_coord tile rows": lambda: tuple(
                k56.rmatvec_cuda(fa, f_t, e, False, lv, True)
                for e in one_hot(fa.shape[0], ROWS, dev)),
            "affinity_strip_coord_f32": lambda: k1.affinity_strip_cuda(
                x["a3"], x["b3"], coords=True),
            "affinity_strip_coord_bf16": lambda: k1.affinity_strip_cuda(
                x["a3"], x["b3"], torch.float32, torch.bfloat16, coords=True),
            "kb_strip_f32 131 tiles": lambda: k79.kb_strip_cuda(
                fa, f_t[:, :128 * K7_TILES].contiguous(),
                x["cols"][:128 * K7_TILES], False, lv),
            "affinity_strip_coord_f32 300 x 65499": lambda: k1.affinity_strip_cuda(
                x["a3r"], x["b3r"], coords=True),
            "affinity_strip_coord_bf16 300 x 65499": lambda: k1.affinity_strip_cuda(
                x["a3r"], x["b3r"], torch.float32, torch.bfloat16, coords=True),
        }
        for name, fn in cases.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            out[f"{name}, {-(-d // 4) * 4} live"] = [g.contiguous().cpu()
                                                      for g in got]
        torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32_same_bits: no CUDA card")
    dev = torch.device("cuda", 0)
    if args.child:       # inside the other checkout's process
        torch.save(run(dev), args.child)
        return
    parent = Path(args.parent).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    theirs = OUT / "parent.pt"
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "sys.path.insert(1, sys.argv[2]); sys.argv = sys.argv[2:]; "
                    "import f32_same_bits as m; m.main()",
                    str(parent), str(Path(__file__).resolve().parent),
                    "--parent", str(parent), "--child", str(theirs)],
                   check=True)
    sys.path.insert(0, str(ROOT))
    mine = run(dev)
    ref = torch.load(theirs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = {}
    for key, outs in mine.items():
        rows[key] = dict(equal=all(torch.equal(a, b) for a, b in
                                   zip(outs, ref[key])),
                         max_abs_diff=max(float((a.float() - b.float()).abs().max())
                                          for a, b in zip(outs, ref[key])))
        print(f"{key}: {rows[key]}", flush=True)
    print(json.dumps(dict(card=card, parent=str(parent), outputs=rows)),
          flush=True)


if __name__ == "__main__":
    main()
