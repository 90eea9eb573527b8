"""On-card smoke run of graphlap_tpu_torch: the config-2 strip_cache denoise
path on one NVIDIA GPU, through its hand-written CUDA kernels.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero before
the last line is printed):

1. device  — CUDA must be available; prints the card's name and power limit.
2. build   — compiles graphlap_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. kernels — K1-K4 at the main path's shapes (p=5243 padded to 5248 rows,
             N=512*512, bf16 strip, sketch width 256), each against its
             plain PyTorch version on the card, timed with CUDA events.
4. e2e     — the bench.make_workload recipe (512x512 test image, noise
             sigma 0.1 seed 1, CONFIG2 + strip_cache/kernels/sketch o206 p0)
             through graphlap_tpu_torch.filter_image: one warm-up and three
             timed runs, launch counts, peak memory, PSNR in/out; the same
             factor through the plain versions on the card; and a 96x96
             image on the card against the plain versions on the CPU.
5. result  — one JSON line per kernel, then the contract line
             {"ok": true, "device": {...}}.

Needs one CUDA card and the CUDA toolkit; imports neither JAX nor the JAX
package. Extra detail (nvcc's register report, all numbers) goes to
build/chip_smoke/chip_smoke.json and build/chip_smoke/ptxas.txt.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H = W = 512
RUNS = 3
# kernel vs plain tolerances at the main-path shapes: absolute for the
# strip (its entries lie in [0, 1]), else relative to max|plain|
TOL = {
    # bf16 store: the kernel's f32 FMA order moves d2 by ~1e-6, which can
    # flip a stored value by one bf16 ulp (2^-8 below 1.0)
    "affinity_strip": 2.0 ** -8,
    # f32 sums in another order over P=5248 rows / N=262144 columns
    "strip_ext2": 1e-4,
    # as K2, plus ws re-rounded to bf16 where the f32 sums straddle a
    # rounding boundary (one ulp, 2^-8 relative, on a few entries)
    "strip_sandwich_spost": 2e-3,
    "strip_sandwich": 2e-3,
}
NAMES = list(TOL)
REPLACES = {
    "affinity_strip": "graphlap_tpu/ops/pallas_affinity.py:76",
    "strip_ext2": "graphlap_tpu/ops/pallas_streaming.py:940",
    "strip_sandwich_spost": "graphlap_tpu/ops/pallas_streaming.py:1045",
    "strip_sandwich": "graphlap_tpu/ops/pallas_streaming.py:1110",
}
SOURCE = {
    "affinity_strip": "graphlap_tpu_torch/csrc/affinity_strip.cu",
    "strip_ext2": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich_spost": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
}
OUT = Path("build") / "chip_smoke"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def require(ok, msg: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over ``reps`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that divided by max |ref|) over paired outputs."""
    err = scale = 0.0
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        require(g.shape == r.shape, f"shape {g.shape} != {r.shape}")
        require(bool(torch.isfinite(g).all()), "non-finite kernel output")
        err = max(err, float((g - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    return err, err / max(scale, 1e-30)


def make_workload(gt):
    """bench.make_workload's recipe, rebuilt on the port: (cfg, clean image,
    noisy f32 image, plan)."""
    cfg = gt.CONFIG2.replace(streaming=True, strip_cache=True,
                             block_cols=H * W, use_pallas=True,
                             affinity_dtype="bfloat16_store",
                             sinkhorn_iters=6, solver="sketch",
                             sketch_oversample=206, sketch_power=0,
                             sinkhorn_coarse=16, sinkhorn_polish=1)
    img = gt.make_test_image(H, W)
    noisy = np.ascontiguousarray(
        np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1), np.float32)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script runs only on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ptxas.txt").write_text(_build.PTXAS_LOG)
    spills = [ln.strip() for ln in _build.PTXAS_LOG.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    phase("build", f"{build_s:.1f} s; ptxas spill lines: {spills}")

    # 4a. the workload (built first: phase 3 takes its shapes and strip)
    cfg, img, noisy, plan = make_workload(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)

    # 3. kernels at the main path's shapes, on the path's own strip
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    strip, p = ctx.strip_pad, ctx.p
    pp, n = strip.shape
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, p)
    kp = -(-k // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    feats_a = torch.full((pp, ctx.feats_a.shape[1]), 1e3, device=dev)
    feats_a[:p] = ctx.feats_a
    t2 = torch.zeros((2, pp), device=dev)
    t2[:, :p] = 0.5 + rand(2, p)
    ta = torch.zeros((pp, kp), device=dev)
    ta[:p] = rand(p, kp) - 0.5
    t1 = torch.zeros(pp, device=dev)
    t1[:p] = 0.5 + rand(p)
    s_pre = (0.5 + rand(n)) * ctx.b_mask
    s2 = (0.5 + rand(n)) * ctx.b_mask
    cases = {
        "affinity_strip": (k1.affinity_strip_cuda, k1.affinity_strip_plain,
                           (feats_a, ctx.feats_pad, torch.float32,
                            torch.bfloat16)),
        "strip_ext2": (k24.strip_ext2_cuda, k24.strip_ext2_plain,
                       (strip, t2, ctx.b_mask)),
        "strip_sandwich_spost": (k24.strip_sandwich_spost_cuda,
                                 k24.strip_sandwich_spost_plain,
                                 (strip, ta, t1, s_pre, ctx.b_mask)),
        "strip_sandwich": (k24.strip_sandwich_cuda, k24.strip_sandwich_plain,
                           (strip, ta, s2)),
    }
    rows = {}
    for name, (kern, plain, args) in cases.items():
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        pair = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        err, rel = max_rel_err(*pair)
        if name == "affinity_strip":
            rel = err                                 # absolute, see TOL
        ms_k = cuda_ms(lambda: kern(*args), 5)
        ms_p = cuda_ms(lambda: plain(*args), 2)
        phase("kernel", f"{name}: max_abs_err {err:.3e} (rel {rel:.3e}, tol "
              f"{TOL[name]:.1e}); kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
        require(rel <= TOL[name], f"{name} disagrees with its plain version")
        rows[name] = dict(max_abs_err=err, rel_err=rel, ms=ms_k, plain_ms=ms_p)
        del got, ref
    del ctx, strip, cases
    torch.cuda.empty_cache()

    # 4b. end to end through the public entry point
    gt.filter_image(noisy, cfg, plan=plan, device=dev)          # warm-up
    torch.cuda.synchronize()
    counters = (k1.affinity_strip_cuda, k24.strip_ext2_cuda,
                k24.strip_sandwich_spost_cuda, k24.strip_sandwich_cuda)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        res = gt.filter_image(noisy, cfg, plan=plan, device=dev)
        walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in zip(NAMES, counters)}
    peak = torch.cuda.max_memory_allocated()
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB; launches {launches}")
    require(res.image.shape == (H, W) and np.isfinite(res.image).all(),
            "output is not a finite (H, W) image")
    require(psnr_out > psnr_in + 5.0, "denoise gain under 5 dB")
    for name, c in launches.items():
        require(c > 0, f"{name}: the main path never launched its kernel")

    # same factor, plain versions on the card
    z_plain, _ = _filter_channel(img_d, idx_d, cfg, plain=True)
    z_plain = z_plain.cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("e2e", f"kernel vs plain path on the card: {d_db:.5f} dB, max "
          f"|diff| {d_max:.3e} (bar 0.05 dB, 2e-2)")
    require(d_db <= 0.05 and d_max <= 2e-2, "kernel path != plain path")

    # small input: kernels on the card vs plain versions on the CPU
    small = cfg.replace(block_cols=96 * 96, sinkhorn_coarse=4)
    im_s = gt.make_test_image(96, 96)
    nz_s = np.clip(gt.add_gaussian_noise(im_s, 0.1, seed=1), 0,
                   1).astype(np.float32)
    pl_s = gt.make_plan(nz_s, small)
    k_s = min(small.num_eigvecs + small.sketch_oversample, pl_s.p)
    om = ms.sketch_omega(pl_s.p, k_s, "cpu")
    z_cpu, _ = _filter_channel(torch.as_tensor(nz_s),
                               torch.as_tensor(pl_s.idx_a.astype(np.int64)),
                               small, om)
    z_gpu, _ = _filter_channel(torch.as_tensor(nz_s, device=dev),
                               torch.as_tensor(pl_s.idx_a.astype(np.int64),
                                               device=dev), small, om.to(dev))
    z_cpu, z_gpu = z_cpu.numpy(), z_gpu.cpu().numpy()
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"96x96 card kernels vs CPU plain: {s_db:.5f} dB, max "
          f"|diff| {s_max:.3e}; PSNR {gt.psnr(im_s, nz_s):.3f} -> "
          f"{gt.psnr(im_s, z_gpu):.3f} dB")
    require(np.isfinite(z_gpu).all() and s_db <= 0.05 and s_max <= 2e-2,
            "96x96 card run != CPU plain run")

    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"], ms=rows[name]["ms"],
                    plain_ms=rows[name]["plain_ms"]) for name in NAMES]
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, kernels=kernels, rows=rows, walls_s=walls,
        peak_bytes=peak, psnr_in=psnr_in, psnr_out=psnr_out,
        plain_path_db=d_db, plain_path_max=d_max, small_db=s_db,
        small_max=s_max, torch=torch.__version__), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
