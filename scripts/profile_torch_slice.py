"""Where the time of graphlap_tpu_torch's ported paths goes, on one CUDA
card.

    python3 scripts/profile_torch_slice.py
        [--path config2|config2f32|config2p7|config2p9|config2p11|config4|
                config4p7|config4p9|config4p11|config3|config3p7|config4q|
                config4qp7|turbo|turbop11|dense|bilateral|bilateralA|
                bilateralB|bilateralBp11|bilateralC|bilateralCp11|both|all]
        [--out DIR]

For each path (config 2: chip_smoke.make_workload, the 512x512 strip_cache
recipe; config 2 f32: chip_smoke.make_workload_f32, the same recipe with
its f32 strip kept (K1's f32 store, the f32 K2-K4); config 2 p7:
chip_smoke.make_workload_p7, config 2 with an NLM 7x7 patch (K1's 64-lane
cross); config 4: chip_smoke.make_workload_8mp, the 8 MP
recompute-streaming fused-finish recipe; config 4 p7:
chip_smoke.make_workload_8mp_p7, the same at 7x7 (the 64-lane K7-K9);
config 2 p9, p11 and config 4 p9, p11: the same two at NLM 9x9 and 11x11
(chip_smoke.make_workload and make_workload_8mp with patch 9 or 11: K1
and K7-K9 at 96 and 128 lanes); turbo p11: the turbo recipe at 11x11;
config 3: chip_smoke.make_workload_cfg3, the 1024x1024
RGB matvec sharpen; config 4q: chip_smoke.make_workload_8mp_matvec, the
8 MP f32 matvec denoise; config 3 p7 and config 4q p7: the two at 7x7
(the 64-lane aug and f32 K5/K6); turbo: chip_smoke.make_workload_8mp_turbo, the 8 MP
turbo recipe on the unfused spectral schedule; dense:
chip_smoke.make_workload_dense, bench.py's f32 twin of config 2 on the dense
path; bilateral: chip_smoke.make_workload_bilateral, the 8 MP bilateral
denoise on f32 tiles (fused finish: the f32 K8, K7 and K9); bilateralA,
bilateralB, bilateralC: the NLM 7x7 recipes with a spatial term
(chip_smoke.make_workload_cfg2_bilateral: config 2's strip_cache, K1's
64-lane coordinate cross; make_workload_8mp_nlm_bilateral: the 8 MP fused
finish, the 64-lane f32 K8, K7, K9; make_workload_8mp_nlm_bilateral_matvec:
the 8 MP matvec denoise, the 64-lane coordinate K5/K6); bilateralBp11:
recipe B at NLM 11x11 (make_workload_8mp_nlm_bilateral with patch 11: the
128-lane f32 K8, K7, K9); bilateralCp11: recipe C at NLM 11x11
(make_workload_8mp_nlm_bilateral_matvec with patch 11: the coordinate
K5/K6 at 124 live lanes of 128); "both" is
config 2 and config 4, "all" every path) it runs
filter_image once to warm up, then:

* stage walls (host clock around work ending in torch.cuda.synchronize,
  min of 3), on channel 0 of an RGB image: the strip context (features,
  K_AA + its Cholesky, and the K1 strip or the recompute layouts), the
  coarse Sinkhorn loop, for the paths outside the fused schedules (the
  operator filters, turbo) the full-resolution extension (plain-torch
  rmatvec2) and the whole normalization (coarse loop, extension and
  polish), for turbo also the eigensolve (K7 cross, LOBPCG, K10), and the
  whole filter_image call; on the dense path the four stages of
  filter_image_staged (affinity, normalize, eigensolve, filter) and, inside
  the eigensolve, the f32 cross GEMM W_AB W_AB^T alone;
* one filter_image call under torch.profiler: device time summed by kernel
  name and by group (the port's kernels, cuBLAS GEMMs, cuSOLVER and the
  other small dense algebra, elementwise and reductions), the device-busy
  share of the call's wall, and the full table in <out>/<path>_table.txt
  (the Chrome trace in <out>/<path>_trace.json).

Prints one JSON line a path with the numbers and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# device kernel name -> group, first match wins (the port's kernels as
# named now and in older checkouts, which this script also profiles)
GROUPS = (
    ("port kernels", r"affinity_kernel|affinity_split_kernel|ext2_kernel|"
                     r"sandwich_kernel|sandwich_split_kernel|split_parts_kernel|"
                     r"kb_emit_kernel|ext2_matvec_kernel|"
                     r"aug_sum_kernel|f32_sum_kernel|"
                     r"colstats_v_kernel|ks_kernel|reduce_partials|"
                     r"affinity_coord_kernel|coord_tile_kernel|coord_norms_kernel|"
                     r"coord_sum_kernel|"
                     r"kb_f32_kernel|coord_store_kernel|coord_pack_kernel|"
                     r"ext2_f32_kernel|ext2_f32_tile_kernel|ext2_norms_kernel|"
                     r"colstats_tc_kernel|split_cols_kernel|"
                     r"colstats_f32_kernel|colstats_f32_wide_kernel|ks_f32_kernel"),
    ("cuSOLVER / small dense algebra",
     r"syevd|syevj|jacobi|potrf|potrs|trsm|trsv|geqrf|orgqr|orgbr|ormqr|"
     r"gesvd|gebrd|bdsqr|lansy|sytrd|stedc|steqr|larf|laswp|cusolver|"
     r"magma|batch_"),
    ("cuBLAS GEMM / GEMV", r"gemm|gemv|xmma|cutlass|sm90_|ampere_|dot_kernel"),
    ("elementwise / reductions", r"elementwise|vectorized|reduce|index|"
                                 r"scatter|gather|copy|fill|cat|where|exp|"
                                 r"sqrt|clamp|arange|Memcpy|Memset"),
)


def _wall(fn, reps: int = 3) -> float:
    """Min seconds of fn() over ``reps`` synchronized runs."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _group(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name, re.IGNORECASE):
            return group
    return "other"


def dense_stages(gt, cfg, noisy, plan, dev) -> dict:
    """The dense path's stage walls (min of 3 filter_image_staged calls a
    stage) and the f32 cross GEMM alone on the path's scaled strip."""
    from graphlap_tpu_torch.models import pipeline as mp
    from graphlap_tpu_torch.ops.affinity import affinity_blocks
    from graphlap_tpu_torch.ops.nystrom import _cross_gemm
    from graphlap_tpu_torch.ops.sinkhorn import normalize_blocks

    runs = [gt.filter_image_staged(noisy, cfg, plan=plan, device=dev).timings
            for _ in range(3)]
    stages = {f"{k}_s": min(r[k] for r in runs) for k in runs[0]}
    idx_a, perm, _ = mp._plan_to(plan, cfg, dev)
    kaa, kab = affinity_blocks(torch.as_tensor(noisy, device=dev), idx_a,
                               perm, cfg)
    _, wab, _, _ = normalize_blocks(kaa, kab, cfg.normalization,
                                    cfg.sinkhorn_iters, cfg.eig_tol,
                                    cfg.solver, cfg.sinkhorn_coarse,
                                    cfg.sinkhorn_polish)
    del kab
    gdt = (torch.bfloat16 if cfg.gram_gemm_dtype() == "bfloat16"
           else torch.float32)
    stages["cross_gemm_s"] = _wall(lambda: _cross_gemm(wab, gdt))
    stages["filter_image_s"] = _wall(
        lambda: gt.filter_image(noisy, cfg, plan=plan, device=dev))
    return stages


def profile_path(tag, workload, gt, dev, out: Path) -> dict:
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import streaming as st

    cfg, _, noisy, plan = workload(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    if img_d.ndim == 3:
        img_d = img_d[..., 0].contiguous()
    idx_d = torch.as_tensor(plan.idx_a.astype("int64"), device=dev)
    gt.filter_image(noisy, cfg, plan=plan, device=dev)          # warm-up
    if not cfg.streaming:
        return dict(path=tag, stages=dense_stages(gt, cfg, noisy, plan, dev),
                    **device_profile(tag, gt, cfg, noisy, plan, dev, out))

    stages = {}
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    stages["strip_ctx_s"] = _wall(lambda: ms._strip_ctx(img_d, idx_d, cfg))
    stages["coarse_sinkhorn_s"] = _wall(
        lambda: ms._coarse_sinkhorn_state(ctx, cfg))
    fused = ms._fused_finish_ok(ctx, cfg) or ms._strip_fused_ok(ctx, cfg)
    if cfg.operator_filter() or not fused:
        t2 = torch.ones((ctx.p, 2), device=dev)
        stages["rmatvec2_s"] = _wall(lambda: st.rmatvec2(
            ctx.feats_a, ctx.feats_pad, t2, ctx.b_mask, ms.CUDA_CHUNK,
            ctx.dtype))
        stages["normalize_s"] = _wall(
            lambda: ms._normalize_streaming(ctx, cfg))
    if not (cfg.operator_filter() or fused):
        s = ms._normalize_streaming(ctx, cfg)
        stages["eigensolve_s"] = _wall(
            lambda: ms._eigensolve_streaming(img_d, ctx, s, cfg))
    stages["filter_image_s"] = _wall(
        lambda: gt.filter_image(noisy, cfg, plan=plan, device=dev))
    del ctx
    torch.cuda.empty_cache()
    return dict(path=tag, stages=stages,
                **device_profile(tag, gt, cfg, noisy, plan, dev, out))


def device_profile(tag, gt, cfg, noisy, plan, dev, out: Path) -> dict:
    """One filter_image call under torch.profiler: device time by kernel
    and group, the busy share, host linalg ops; table and trace to out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gt.filter_image(noisy, cfg, plan=plan, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
            else "cuda_time_total")
    by_kernel = sorted(((e.key, getattr(e, attr) / 1e3, e.count) for e in ka
                        if getattr(e, attr) > 0 and e.device_type is not None
                        and "cuda" in str(e.device_type).lower()),
                       key=lambda kv: -kv[1])
    by_group: dict[str, float] = {}
    for name, ms_, _ in by_kernel:
        by_group[_group(name)] = by_group.get(_group(name), 0.0) + ms_
    device_ms = sum(ms_ for _, ms_, _ in by_kernel)
    host_ops = sorted(((e.key, e.cpu_time_total / 1e3, e.count) for e in ka
                       if e.key.startswith(("aten::linalg", "aten::_linalg",
                                            "aten::item",
                                            "aten::_local_scalar"))),
                      key=lambda kv: -kv[1])[:8]
    (out / f"{tag}_table.txt").write_text(ka.table(sort_by=attr,
                                                   row_limit=80))
    prof.export_chrome_trace(str(out / f"{tag}_trace.json"))
    return dict(profiled_wall_s=wall,
                device_kernel_ms=device_ms,
                device_busy_share=device_ms / 1e3 / wall if wall else None,
                by_group_ms=by_group, top_kernels_ms_count=by_kernel[:15],
                host_linalg_ms_count=host_ops)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("config2", "config2f32", "config2p7",
                                       "config2p9", "config2p11", "config4p9",
                                       "config4p11", "turbop11",
                                       "config4", "config4p7", "config3",
                                       "config3p7", "config4q", "config4qp7",
                                       "turbo", "dense", "bilateral",
                                       "bilateralA", "bilateralB",
                                       "bilateralBp11", "bilateralC",
                                       "bilateralCp11", "both", "all"),
                    default="both")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import chip_smoke
    import graphlap_tpu_torch as gt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    paths = {"config2": chip_smoke.make_workload,
             "config2f32": chip_smoke.make_workload_f32,
             "config2p7": chip_smoke.make_workload_p7,
             "config4": chip_smoke.make_workload_8mp,
             "config4p7": chip_smoke.make_workload_8mp_p7,
             "config2p9": lambda g: chip_smoke.make_workload(g, 9),
             "config2p11": lambda g: chip_smoke.make_workload(g, 11),
             "config4p9": lambda g: chip_smoke.make_workload_8mp(g, patch=9),
             "config4p11": lambda g: chip_smoke.make_workload_8mp(g, patch=11),
             "turbop11": lambda g: chip_smoke.make_workload_8mp_turbo(g, 11),
             "config3": chip_smoke.make_workload_cfg3,
             "config3p7": lambda g: chip_smoke.make_workload_cfg3(g, 7),
             "config4q": chip_smoke.make_workload_8mp_matvec,
             "config4qp7": lambda g: chip_smoke.make_workload_8mp_matvec(g, 7),
             "turbo": chip_smoke.make_workload_8mp_turbo,
             "dense": chip_smoke.make_workload_dense,
             "bilateral": chip_smoke.make_workload_bilateral,
             "bilateralA": chip_smoke.make_workload_cfg2_bilateral,
             "bilateralB": chip_smoke.make_workload_8mp_nlm_bilateral,
             "bilateralBp11": lambda g: (
                 chip_smoke.make_workload_8mp_nlm_bilateral(g, 11)),
             "bilateralC": chip_smoke.make_workload_8mp_nlm_bilateral_matvec,
             "bilateralCp11": lambda g: (
                 chip_smoke.make_workload_8mp_nlm_bilateral_matvec(g, 11))}
    chosen = {"both": ("config2", "config4"), "all": tuple(paths)}.get(
        args.path, (args.path,))
    for tag, workload in paths.items():
        if tag in chosen:
            res = profile_path(tag, workload, gt, dev, out)
            print(json.dumps(dict(card=card, **res)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
