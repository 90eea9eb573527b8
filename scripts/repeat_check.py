"""Does graphlap_tpu_torch repeat itself? The 96x96 config-2 check of
chip_smoke.py (the strip_cache recipe with the sketch eigensolver, a fixed
Omega), run twice on one input on the card and twice on the CPU, with every
dense-algebra call recorded: the K_AA Cholesky and the triangular solves,
the sketch's eigh / Cholesky / QR, the p x p eigh, and every matrix product.

    python3 scripts/repeat_check.py [--device cuda|cpu] [--out DIR]

For each device it names the first recorded call whose output differs
between the two runs (op, call index, shape, max |diff|), or says that the
runs agree bit for bit, and the card-vs-CPU difference of the images.
A SHA-256 of each run's recorded outputs goes into
<out>/repeat_check.json, so that runs in two processes (two calls on two
machines) can be compared as well. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OPS = (("linalg", "cholesky"), ("linalg", "eigh"), ("linalg", "qr"),
       ("linalg", "solve_triangular"), ("linalg", "solve"), (None, "matmul"),
       (None, "mm"))


class Recorder:
    """Wraps the dense-algebra entry points of torch; while ``on``, every
    call appends (name, output as f64 numpy arrays)."""

    def __init__(self):
        self.calls, self.on = [], False

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                outs = out if isinstance(out, tuple) else (out,)
                self.calls.append((name, [o.detach().double().cpu().numpy()
                                          for o in outs
                                          if isinstance(o, torch.Tensor)]))
            return out
        return wrapped

    def install(self):
        for mod, name in OPS:
            owner = torch.linalg if mod == "linalg" else torch
            setattr(owner, name, self._wrap(f"{mod or 'torch'}.{name}",
                                            getattr(owner, name)))
        torch.Tensor.__matmul__ = self._wrap("@", torch.Tensor.__matmul__)

    def run(self, fn):
        self.calls, self.on = [], True
        try:
            out = fn()
        finally:
            self.on = False
        return out, self.calls


def digest(calls) -> str:
    h = hashlib.sha256()
    for name, arrs in calls:
        h.update(name.encode())
        for a in arrs:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def first_difference(a, b):
    """(index, op, shape, max |diff|) of the first call that differs, or
    None when the two runs recorded the same calls bit for bit."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return dict(index=-1, op="the sequence of calls differs")
    for i, ((name, xa), (_, xb)) in enumerate(zip(a, b)):
        for ya, yb in zip(xa, xb):
            if not np.array_equal(ya, yb):
                return dict(index=i, op=name, shape=list(ya.shape),
                            max_abs_diff=float(np.abs(ya - yb).max()))
    return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/repeat_check")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("repeat_check: no CUDA card")

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    import chip_smoke as cs

    cfg = cs.make_workload(gt)[0].replace(block_cols=96 * 96,
                                          sinkhorn_coarse=4)
    im, nz = cs.noisy_image(gt, 96, 96)
    plan = gt.make_plan(nz, cfg)
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
    om = ms.sketch_omega(plan.p, k, "cpu")
    idx = plan.idx_a.astype(np.int64)
    rec = Recorder()
    rec.install()
    runs = {}
    for dev in dict.fromkeys([args.device, "cpu"]):
        def once(dev=dev):
            z, _ = _filter_channel(torch.as_tensor(nz, device=dev),
                                   torch.as_tensor(idx, device=dev), cfg,
                                   om.to(dev))
            if dev != "cpu":
                torch.cuda.synchronize()
            return z.cpu().numpy()
        runs[dev] = [rec.run(once) for _ in range(2)]
    res = {}
    for dev, ((z1, c1), (z2, c2)) in runs.items():
        res[dev] = dict(calls=len(c1), digests=[digest(c1), digest(c2)],
                        psnr=[gt.psnr(im, z1), gt.psnr(im, z2)],
                        image_max_diff=float(np.abs(z1 - z2).max()),
                        first_difference=first_difference(c1, c2))
    if args.device != "cpu":
        zg, zc = runs[args.device][0][0], runs["cpu"][0][0]
        res["card_vs_cpu"] = dict(db=abs(gt.psnr(im, zg) - gt.psnr(im, zc)),
                                  max_diff=float(np.abs(zg - zc).max()))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "repeat_check.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
