"""The port's command-line interface (``graphlap_tpu/cli.py``): the same
single-dash flags, rc file and preset rules, running on the CUDA card.

    python -m graphlap_tpu_torch.cli -f in.png -o out.png -kernel nlm \
        -patch 11 -spatial_h 8 -sample 0.02 -preset fast -noise 0.1 -log_view

The run is on the card (the hand-written kernels); ``-cpu`` runs it on the
CPU through the kernels' plain PyTorch versions. Without ``-cpu`` on a
machine with no CUDA card the CLI raises; it never carries on on the
CPU. Default options are read from ``~/.graphlaprc`` (or the file named by
``-opts_file``) as the reference reads them. Flags whose modules are not
ported yet (``-load_basis``, ``-save_basis``, ``-tile``, ``-tune_sure``,
``-ds_check``) raise ``NotImplementedError`` naming their ROADMAP.md item
before any work. As in the reference, argparse keeps ``-h`` for help, so
the kernel bandwidth is ``-h_param``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

RC_FILE = os.path.expanduser("~/.graphlaprc")


def _read_opts_file(path: str) -> list[str]:
    """PETSc-rc-style option file -> argv prefix (CLI args win: argparse
    takes the LAST occurrence of a flag)."""
    args: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                args.extend(line.split())
    return args


def _with_rc_defaults(argv: list[str]) -> list[str]:
    argv = list(argv)
    path = None
    for i, tok in enumerate(argv):
        if tok == "-opts_file":
            if i + 1 >= len(argv):
                raise SystemExit("error: -opts_file expects a path argument")
            path = argv[i + 1]
            del argv[i:i + 2]
            break
        if tok.startswith("-opts_file="):
            path = tok.split("=", 1)[1]
            if not path:
                raise SystemExit("error: -opts_file expects a path argument")
            del argv[i]
            break
    if path is None and os.path.exists(RC_FILE):
        path = RC_FILE
    return (_read_opts_file(path) + argv) if path else argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphlap_tpu_torch",
        description="global image filtering via the graph Laplacian, in "
                    "PyTorch with hand-written CUDA kernels",
    )
    p.add_argument("-f", dest="input", required=True, help="input image path")
    p.add_argument("-o", dest="output", default=None, help="output image path")
    p.add_argument("-kernel", choices=["gaussian", "nlm"], default="gaussian")
    p.add_argument("-h_param", type=float, default=0.15,
                   help="photometric bandwidth h (image range [0,1])")
    p.add_argument("-spatial_h", type=float, default=0.0,
                   help="bilateral spatial bandwidth in px (0 = off)")
    p.add_argument("-patch", type=int, default=5, help="NLM patch side")
    p.add_argument("-sample", type=float, default=0.01,
                   help="Nystrom sample fraction of pixels")
    p.add_argument("-sample_cap", type=int, default=8192,
                   help="hard cap on sample count p")
    p.add_argument("-sample_mode", choices=["grid", "random"], default="grid",
                   help="'grid' = reference-style spatially uniform; "
                        "'random' = seeded uniform random subset (GLIDE)")
    p.add_argument("-sample_seed", type=int, default=0,
                   help="seed for -sample_mode random")
    p.add_argument("-eigvals", type=int, default=50,
                   help="number of eigenpairs m")
    p.add_argument("-filter", dest="filter_name", default="identity",
                   choices=["identity", "power", "lowpass", "sharpen",
                            "exp_decay", "twicing"])
    p.add_argument("-filter_param", type=float, default=1.0,
                   help="k for power, beta for sharpen, tau for exp_decay")
    p.add_argument("-filter_mode", default="spectral",
                   choices=["spectral", "matvec", "chebyshev"],
                   help="'spectral' = f(lambda) through the rank-m Nystrom "
                        "eigenbasis (reference form); 'matvec' = EXACT f(W) "
                        "by strip matvecs for polynomial filters (identity/"
                        "power/sharpen/twicing with integer k); "
                        "'chebyshev' = degree-cheb_degree series of f by "
                        "the matvec recurrence")
    p.add_argument("-cheb_degree", type=int, default=12,
                   help="chebyshev mode: series degree = number of strip "
                        "matvecs; 0 = auto (smallest degree with series "
                        "tail bound <= 1e-6)")
    p.add_argument("-rgb_mode", choices=["per_channel", "luma_basis"],
                   default="per_channel",
                   help="'per_channel' = C independent pipelines (reference "
                        "behavior); 'luma_basis' = one eigenbasis from the "
                        "BT.601 luminance graph (not ported yet: raises)")
    p.add_argument("-normalization", default="sinkhorn",
                   choices=["sinkhorn", "symmetric", "none"])
    p.add_argument("-sinkhorn_iters", type=int, default=20)
    p.add_argument("-sinkhorn_coarse", type=int, default=1,
                   help="streaming only: iterate Sinkhorn against every "
                        "k-th column (8 MP-scale accelerator)")
    p.add_argument("-sinkhorn_polish", type=int, default=0,
                   help="full-resolution polish iterations after coarse "
                        "Sinkhorn")
    p.add_argument("-sinkhorn_sample", default="auto",
                   choices=["auto", "diag", "stride"],
                   help="coarse-Sinkhorn column sample on streaming paths: "
                        "auto (diagonal on strip_cache, plain stride on "
                        "recompute), diag, or stride")
    p.add_argument("-gram_coarse", type=int, default=1,
                   help="streaming only: estimate the O(Np^2) cross from "
                        "every k-th column (8 MP-scale accelerator)")
    p.add_argument("-preset", default=None,
                   choices=["exact", "fast", "turbo"],
                   help="apply a measured-recipe preset (config.tuned_config)"
                        ": 'exact' = all-f32 parity baseline; 'fast' = "
                        "bf16 storage/tiles + the fused kernels + calibrated "
                        "decimations; 'turbo' = max single-card speed. "
                        "Explicit precision/decimation flags override the "
                        "preset")
    p.add_argument("-tune_denoise", action="store_true",
                   help="set the kernel bandwidths from the noise level "
                        "(config.denoise_tuned). sigma = -noise when given, "
                        "else estimated from the image (wavelet-MAD, "
                        "metrics.estimate_noise_sigma). Explicit -h_param/"
                        "-spatial_h flags win")
    p.add_argument("-tune_sure", action="store_true",
                   help="pick the bandwidth h by minimizing Stein's "
                        "unbiased risk estimate (not ported yet: raises "
                        "unless -h_param is given, which wins)")
    p.add_argument("-noise", type=float, default=0.0,
                   help="experiment mode: add Gaussian noise of this std "
                        "before filtering and report PSNR vs the clean input")
    p.add_argument("-seed", type=int, default=0, help="noise seed")
    p.add_argument("-grayscale", action="store_true",
                   help="convert input to grayscale")
    p.add_argument("-bf16", action="store_true",
                   help="bfloat16 affinity GEMMs (faster, small PSNR cost)")
    p.add_argument("-bf16_store", action="store_true",
                   help="f32 affinity math, bf16 strip STORAGE (halves "
                        "Sinkhorn bandwidth at near-zero PSNR cost; dense "
                        "path)")
    p.add_argument("-gram_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="dense path: dtype of the one-shot cross GEMM only")
    p.add_argument("-feature_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the (N, d) feature tensor "
                        "(bfloat16 not ported yet: raises)")
    p.add_argument("-solver", default="lobpcg",
                   choices=["lobpcg", "chol", "oneshot", "sketch"],
                   help="eigensolver (see docs/ARCHITECTURE.md section 4)")
    p.add_argument("-streaming", action="store_true",
                   help="blockwise recompute path (big images, no K strip)")
    p.add_argument("-block_cols", type=int, default=65536,
                   help="streaming column-block width")
    p.add_argument("-strip_cache", action="store_true",
                   help="streaming: materialize the kernel strip once "
                        "(natural order) instead of recomputing tiles")
    p.add_argument("-pallas", action="store_true",
                   help="the fused hand-written kernels for the affinity/"
                        "matvec path (the reference's Pallas flag)")
    p.add_argument("-fused_finish", action="store_true",
                   help="streaming + fused kernels: collapse the coarse-"
                        "Sinkhorn factor's four full-res sweeps into two "
                        "passes (needs -sinkhorn_coarse/-gram_coarse > 1 "
                        "and -sinkhorn_polish 1)")
    p.add_argument("-save_basis", default=None,
                   help="write the eigenbasis to this .npz for filter replay "
                        "(not ported yet: raises)")
    p.add_argument("-load_basis", default=None,
                   help="replay -filter/-filter_param through a saved basis "
                        "(not ported yet: raises)")
    p.add_argument("-tile", type=int, default=0,
                   help="out-of-core mode: filter in overlapping square "
                        "tiles of this side (not ported yet: raises; 0 = "
                        "whole image)")
    p.add_argument("-tile_overlap", type=int, default=256,
                   help="inter-tile overlap / blend-ramp width in px")
    p.add_argument("-log_view", action="store_true",
                   help="print per-stage wall-clock timings (PETSc-style)")
    p.add_argument("-ds_check", action="store_true",
                   help="print the Sinkhorn doubly-stochastic residual "
                        "(not ported yet: raises on a sinkhorn run)")
    p.add_argument("-trace_dir", default=None,
                   help="write a torch.profiler Chrome trace to this "
                        "directory")
    p.add_argument("-json_log", default=None,
                   help="append a structured JSON run record to this file")
    p.add_argument("-cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch "
                        "versions); without it the run is on the CUDA card")
    p.add_argument("-opts_file", default=None,
                   help="option defaults file (PETSc-rc style: one '-flag "
                        "value' per line, # comments); ~/.graphlaprc is "
                        "read automatically; CLI flags override")
    return p


# flag name -> PipelineConfig fields it pins; a preset never overrides a
# field whose flag the user (or the rc file) spelled out
_PRESET_GUARDED_FLAGS = {
    "bf16": ("affinity_dtype",), "bf16_store": ("affinity_dtype",),
    "gram_dtype": ("gram_dtype",), "feature_dtype": ("feature_dtype",),
    "pallas": ("use_pallas",),
    "sinkhorn_iters": ("sinkhorn_iters",),
    "sinkhorn_coarse": ("sinkhorn_coarse",),
    "sinkhorn_polish": ("sinkhorn_polish",), "gram_coarse": ("gram_coarse",),
    "sinkhorn_sample": ("sinkhorn_sample",),
    "fused_finish": ("fused_finish",),
    "strip_cache": ("strip_cache",),
    "solver": ("solver", "sketch_oversample", "sketch_power"),
    "filter_mode": ("filter_mode",),
    # asking for a basis checkpoint is choosing the spectral form
    "save_basis": ("filter_mode",),
    # guarded against -tune_denoise (not presets, which leave them alone)
    "h_param": ("h",), "spatial_h": ("spatial_h",),
}


@functools.lru_cache(maxsize=1)
def _parser_flag_names() -> frozenset:
    """Every option string build_parser defines, bare of dashes: how
    argparse resolves a token (an exact match wins over an abbreviation)."""
    return frozenset(opt.lstrip("-")
                     for action in build_parser()._actions
                     for opt in action.option_strings)


def _explicit_fields(argv: list[str]) -> frozenset:
    """Config fields pinned by flags the user actually typed, so a preset
    never overrides an explicit choice. An exact flag name pins only its
    own guarded fields (``-f img.png`` and ``-filter sharpen`` pin no
    filter_mode); a non-exact token is an abbreviation and pins every
    guarded flag it prefixes (argparse itself errors on an ambiguous one)."""
    fields = set()
    known = _parser_flag_names()
    for tok in argv:
        if not tok.startswith("-"):
            continue
        name = tok.lstrip("-").split("=", 1)[0]
        if not name:
            continue
        if name in known:
            fields.update(_PRESET_GUARDED_FLAGS.get(name, ()))
        else:
            for flag, flds in _PRESET_GUARDED_FLAGS.items():
                if flag.startswith(name):
                    fields.update(flds)
    return frozenset(fields)


def _refuse_unported(args, argv: list[str]) -> None:
    """Raise NotImplementedError, before any work, for each branch of the
    reference's CLI whose module the port does not have yet."""
    todo = []
    if args.load_basis or args.save_basis:
        todo.append(("-load_basis / -save_basis", "M8 (compute_basis and "
                     "utils/checkpoint)"))
    if args.tile > 0:
        todo.append(("-tile", "M8 (models/tiled.filter_image_tiled)"))
    if args.tune_sure and "h" not in _explicit_fields(argv):
        todo.append(("-tune_sure", "M7 (SURE: tune_h_sure)"))
    if args.ds_check and args.normalization == "sinkhorn":
        todo.append(("-ds_check", "M8 (sinkhorn_ds_residual)"))
    if todo:
        flags, items = zip(*todo)
        raise NotImplementedError(
            f"graphlap_tpu_torch.cli: {', '.join(flags)} wait(s) for "
            f"ROADMAP.md Queue 1 {'; '.join(items)}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    argv = _with_rc_defaults(argv)
    args = build_parser().parse_args(argv)
    _refuse_unported(args, argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("graphlap_tpu_torch.cli: no CUDA card here; pass "
                           "-cpu to run the plain PyTorch versions on the CPU")
    device = "cpu" if args.cpu else "cuda"

    import graphlap_tpu_torch as gl
    from graphlap_tpu_torch.config import (AFFINE_FILTERS, denoise_tuned,
                                           tuned_config)
    from graphlap_tpu_torch.models.pipeline import (check_dense_feasible,
                                                    make_plan)
    from graphlap_tpu_torch.utils.timing import log_run, maybe_profile

    cfg = gl.PipelineConfig(
        kernel=args.kernel, h=args.h_param, spatial_h=args.spatial_h,
        patch_size=args.patch, sample_rho=args.sample,
        sample_cap=args.sample_cap, sample_mode=args.sample_mode,
        sample_seed=args.sample_seed, num_eigvecs=args.eigvals,
        normalization=args.normalization, sinkhorn_iters=args.sinkhorn_iters,
        sinkhorn_coarse=args.sinkhorn_coarse,
        sinkhorn_polish=args.sinkhorn_polish,
        sinkhorn_sample=args.sinkhorn_sample, gram_coarse=args.gram_coarse,
        filter_name=args.filter_name, filter_param=args.filter_param,
        filter_mode=args.filter_mode, cheb_degree=args.cheb_degree,
        rgb_mode=args.rgb_mode,
        affinity_dtype=("bfloat16" if args.bf16
                        else "bfloat16_store" if args.bf16_store
                        else "float32"),
        gram_dtype=args.gram_dtype, feature_dtype=args.feature_dtype,
        solver=args.solver, streaming=args.streaming,
        strip_cache=args.strip_cache,
        block_cols=args.block_cols, use_pallas=args.pallas,
        fused_finish=args.fused_finish,
    )

    clean = gl.load_image(args.input, grayscale=args.grayscale)
    image = clean
    if args.noise > 0:
        image = np.clip(gl.add_gaussian_noise(clean, args.noise, args.seed),
                        0, 1)

    if args.tune_denoise:
        sigma = (args.noise if args.noise > 0
                 else gl.estimate_noise_sigma(image))
        cfg = denoise_tuned(cfg, sigma, keep=_explicit_fields(argv))
        print(f"tune_denoise: sigma={sigma:.4f} -> h={cfg.h:.3f} "
              f"spatial_h={cfg.spatial_h:.1f}")

    plan = make_plan(image, cfg)
    base_cfg = cfg

    def _tuned(c):
        if not args.preset:
            return c
        return tuned_config(c, plan.n, args.preset,
                            keep=_explicit_fields(argv))

    # the preset before the dense-feasibility check, so the check sizes the
    # strip with the dtype the run will materialize
    cfg = _tuned(cfg)
    if not cfg.streaming:
        # past the single-device strip bound, switch to the streaming path
        # instead of surfacing the library's ValueError
        try:
            check_dense_feasible(cfg, plan)
        except ValueError:
            print(f"note: dense K strip (p={plan.p} x N={plan.n}) exceeds "
                  f"single-device memory — auto-enabling -streaming")
            # the preset's streaming recipe differs from its dense one
            cfg = _tuned(base_cfg.replace(streaming=True))
    if args.preset:
        print(f"preset {args.preset}: dtype={cfg.affinity_dtype} "
              f"pallas={cfg.use_pallas} sinkhorn={cfg.sinkhorn_iters}"
              f"x{cfg.sinkhorn_coarse}+p{cfg.sinkhorn_polish} "
              f"gram_coarse={cfg.gram_coarse}")
    if args.tune_sure:
        print("tune_sure: explicit -h_param wins; skipping")
    if (cfg.filter_name in AFFINE_FILTERS and cfg.filter_mode == "spectral"
            and (cfg.affinity_dtype != "float32" or cfg.use_pallas
                 or cfg.gram_coarse > 1 or cfg.sinkhorn_coarse > 1
                 or cfg.gram_gemm_dtype() == "bfloat16"
                 or cfg.solver == "sketch")):
        # measured in the reference: accelerated spectral-affine recipes
        # landed 1.8-4.6 dB off the exact trajectory on collapsed spectra
        print(f"warning: accelerated recipes with the rank-m SPECTRAL "
              f"{cfg.filter_name} filter are documented-unstable on "
              f"collapsed kernel spectra (whole-dB deviations measured); "
              f"-filter_mode matvec applies the filter exactly without an "
              f"eigensolve", file=sys.stderr)
    n = image.shape[0] * image.shape[1]
    print(f"image {image.shape}  N={n}  p={plan.p}  m={cfg.num_eigvecs}  "
          f"kernel={cfg.kernel}  filter={cfg.filter_name}  "
          f"config={cfg.config_hash()}  device={device}")

    with maybe_profile(args.trace_dir):
        res = gl.filter_image_staged(image, cfg, plan=plan, device=device)

    record = {
        "input": args.input, "shape": list(image.shape),
        "p": plan.p, "config": cfg.to_dict(),
        "config_hash": cfg.config_hash(),
        "timings_s": res.timings,
        "mp_per_s": (n / 1e6) / max(sum(res.timings.values()), 1e-9),
    }

    if args.noise > 0:
        record["psnr_noisy_db"] = gl.psnr(clean, image)
        record["psnr_filtered_db"] = gl.psnr(clean, res.image)
        record["ssim_filtered"] = gl.ssim(clean, res.image)
        print(f"PSNR noisy {record['psnr_noisy_db']:.3f} dB -> "
              f"filtered {record['psnr_filtered_db']:.3f} dB  "
              f"(SSIM {record['ssim_filtered']:.4f})")

    if args.ds_check:
        print(f"note: -ds_check measures Sinkhorn convergence; "
              f"normalization={cfg.normalization} is not doubly "
              f"stochastic — skipping")

    if args.log_view:
        total = sum(res.timings.values())
        print(f"{'stage':<12}{'seconds':>10}{'share':>8}")
        for k, v in res.timings.items():
            print(f"{k:<12}{v:10.4f}{v / max(total, 1e-12):8.1%}")
        print(f"{'total':<12}{total:10.4f}  ({record['mp_per_s']:.3f} MP/s, "
              f"first call includes the kernel build)")

    if args.output:
        gl.save_image(args.output, res.image)
        print(f"wrote {args.output}")

    if args.json_log:
        log_run(record, args.json_log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
