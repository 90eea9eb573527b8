"""Whether the 32-lane K5/K6 (csrc/recompute_matvec.cu) of this checkout give
the same bits as another checkout's, on one CUDA card.

    python3 scripts/k56_same_bits.py --parent DIR

DIR is another checkout (for example the parent commit unpacked with
``git archive`` into a git-ignored directory) whose K5/K6 take 32 feature
lanes through ``glt_recompute_sum(aug, fixed, strm, w, part, out, Lf, Ls,
splits, blocks, stream)``. Its csrc/recompute_matvec.cu is built alone into
build/k56_same_bits/. Both launch on the same layouts, vectors and launch
plan (this checkout's ``cuda_matvec._plan`` at 32 lanes, whose resident
slots both kernels share): config 3's channel 0 (the bf16 aug layout, p_pad
4096, N 1048576) and the 8 MP matvec denoise (the f32 layout, N 8388608),
the vectors as chip_smoke.matvec_cases makes them. Prints the card line
and one JSON line: for each kernel and shape, whether the two outputs are
equal bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k56_same_bits: no CUDA card")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.EXP_RATE = float("inf")   # chip_smoke.bound's exp rate: bounds unused here

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    src = Path(args.parent).resolve() / "graphlap_tpu_torch" / "csrc" / "recompute_matvec.cu"
    out_dir = ROOT / "build" / "k56_same_bits"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True)
    old = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    old.glt_recompute_sum.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
    old.glt_recompute_sum.restype = I

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    def parent_sum(fixed_t, strm_t, w):
        aug = fixed_t.dtype == torch.bfloat16
        lf, ls = fixed_t.shape[1], strm_t.shape[1]
        splits, blocks = k56._plan(aug, lf, ls, 32)
        out = torch.empty(lf, dtype=torch.float32, device=dev)
        part = out if splits == 1 else torch.empty((splits, lf), device=dev)
        _build.check(old.glt_recompute_sum(
            int(aug), fixed_t.data_ptr(), strm_t.data_ptr(), w.data_ptr(), part.data_ptr(),
            out.data_ptr(), lf, ls, splits, blocks, _build.stream_ptr(fixed_t)),
            "parent recompute_sum")
        return out

    rows = {}
    for tag, make in (("config 3", cs.make_workload_cfg3),
                      ("8 MP matvec", cs.make_workload_8mp_matvec)):
        cfg, _, noisy, plan = make(gt)
        img = torch.as_tensor(noisy, device=dev)
        if img.ndim == 3:
            img = img[..., 0].contiguous()
        ctx = ms._strip_ctx(img, torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg)
        (mv, (_, _, (fa, f_t, v, aug), _)), (rmv, (_, _, (_, _, t, _), _)) = \
            cs.matvec_cases(ctx, dev, ("matvec", "rmatvec"), {})[0].items()
        assert f_t.shape[0] == 32
        w_mv, w_rmv = v.to(fa.dtype).contiguous(), t.to(fa.dtype).contiguous()
        pairs = {
            "matvec": (k56.matvec_cuda(fa, f_t, v, aug),
                       parent_sum(fa.T.contiguous(), f_t.contiguous(), w_mv)),
            "rmatvec": (k56.rmatvec_cuda(fa, f_t, t, aug),
                        parent_sum(f_t.contiguous(), fa.T.contiguous(), w_rmv)),
        }
        for name, (new, ref) in pairs.items():
            rows[f"{tag} {name}"] = dict(
                layout="bf16 aug" if aug else "f32", equal=bool(torch.equal(new, ref)),
                max_abs_diff=float((new - ref).abs().max()))
            print(f"{tag} {name}: {rows[f'{tag} {name}']}", flush=True)
        del ctx, pairs
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, parent=str(args.parent), outputs=rows)), flush=True)


if __name__ == "__main__":
    main()
