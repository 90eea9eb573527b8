"""K8's kbt sum and K9's ks pass (the fused finish's two sweeps,
csrc/recompute_sweeps.cu and csrc/colstats_v.cu) as shipped and in the
designs their source notes replaced, at config 4's 8 MP shapes with NLM 5 x
5 and 7 x 7 patches (32 and 64 feature lanes), on one CUDA card.

    python3 scripts/finish_repairs.py [--reps N] [--out FILE] [--dry]

Each variant is a copy of one source with its text edited, built alone into
its own shared library under build/finish_repairs/<variant>/ (all at once,
one nvcc each, the package's nvcc flags); its entry points take the place
of the package library's while it runs. Variants:

* ``shipped``;
* ``k8 one chain``: K8's kbt one mma chain over a warp's 16-row blocks, from
  zero once a tile, inside the d2 loop (the design before its repair: s
  leaned high);
* ``k9 one chain``: K9's ks pass with a stage's ks one mma chain over its
  16-row steps (before its repair); ``k9 cross spans``: the shipped pass
  with its cross in spans of one k16 step too (each from zero, added in
  f32); ``k9 both spans, ks chain``: the cross in spans, a stage's ks one
  chain (which of the two chains carried the lean);
* ``k9 expf``: the shipped ks pass with each tile entry by expf, as its
  plain version's, in place of kexp (one FMUL, one MUFU ex2): how much of
  K9's s difference the entry's exp carries.

For each variant, patch and turn (--reps, default 2, variants in turn): K8's
and K9's times (CUDA events, chip_smoke.cuda_ms), K8's s and u leans
(chip_smoke.signed_stats: s against the f64 sums of the same bf16 tile
entries, chip_smoke.ext2_recompute_f64; u against the plain version) and
K9's V error in its two parts (chip_smoke.k9_parts). --dry writes the
variant sources and checks the edits without a card. Prints the card line
and one JSON line; --out writes the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"

# K8: the shipped kbt loop after the d2 loop, and the design before its
# repair (one chain, inside the d2 loop)
_K8_D2_END = """        F[b][2 * h] = kent2(pack2(c[0], c[1]));
        F[b][2 * h + 1] = kent2(pack2(c[2], c[3]));
      }
    }
"""
_K8_KBT = """    float kt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int p0 = rw + 16 * b + 2 * tq;
      uint32_t tb[2];
      tb[0] = g < 2 ? ld32(t2_s + g * rb + p0) : 0u;
      tb[1] = g < 2 ? ld32(t2_s + g * rb + p0 + 8) : 0u;
      float kb[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(kb, F[b], tb);
#pragma unroll
      for (int e = 0; e < 4; ++e) kt[e] += kb[e];
    }
"""
_K8_ONE_CHAIN = [
    (_K8_KBT, "", 1),
    ("    ldsm_x4_trans(a1, ap + 16 * X_LDT);\n#pragma unroll\n    for (int b = 0; b < NB; ++b) {",
     "    ldsm_x4_trans(a1, ap + 16 * X_LDT);\n    float kt[4] = {0.f, 0.f, 0.f, 0.f};\n"
     "#pragma unroll\n    for (int b = 0; b < NB; ++b) {", 1),
    (_K8_D2_END, """        F[b][2 * h] = kent2(pack2(c[0], c[1]));
        F[b][2 * h + 1] = kent2(pack2(c[2], c[3]));
      }
      const int p0 = rw + 16 * b + 2 * tq;
      uint32_t tb[2];
      tb[0] = g < 2 ? ld32(t2_s + g * rb + p0) : 0u;
      tb[1] = g < 2 ? ld32(t2_s + g * rb + p0 + 8) : 0u;
      mma16816(kt, F[b], tb);
    }
""", 1)]
_K9_CROSS = """#pragma unroll
      for (int kh = 0; kh < KS; ++kh) mma16816(c, af[ct][kh], bf[h][kh]);"""
_K9_KS_NEW = """        for (int ct = 0; ct < CT; ++ct) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(c, ka[ct], b);
#pragma unroll
          for (int e = 0; e < 4; ++e) kst[ct][e] += c[e];
        }"""
# the ks pass's cross in spans too: each k16 step from zero, added in f32
_K9_CROSS_SPANS = (_K9_CROSS, """      if (SCALED) {
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) mma16816(c, af[ct][kh], bf[h][kh]);
      } else {
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
          float ck[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(ck, af[ct][kh], bf[h][kh]);
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += ck[e];
        }
      }""", 1)
_K9_KS_CHAIN = (_K9_KS_NEW,
                "        for (int ct = 0; ct < CT; ++ct) mma16816(kst[ct], ka[ct], b);", 1)
_TILE_STEP = "template <int FD, bool SCALED>\n__device__ __forceinline__ void tile_step("
# {variant: (source file, [(old, new, occurrences)], what)}
VARIANTS = {
    "shipped": ("colstats_v.cu", [], "as shipped"),
    "k8 one chain": ("recompute_sweeps.cu", _K8_ONE_CHAIN,
                     "K8's kbt one mma chain over the 16-row blocks, in the d2 loop"),
    "k9 one chain": ("colstats_v.cu", [_K9_KS_CHAIN],
                     "K9's ks pass with a stage's ks one mma chain"),
    "k9 cross spans": ("colstats_v.cu", [_K9_CROSS_SPANS],
                       "K9's ks pass with its cross in spans of a k16 step too"),
    "k9 both spans, ks chain": ("colstats_v.cu", [_K9_CROSS_SPANS, _K9_KS_CHAIN],
                                "K9's ks pass with its cross in spans, a stage's ks "
                                "one mma chain"),
    "k9 expf": ("colstats_v.cu", [
        (_TILE_STEP, "template <bool SCALED>\n__device__ __forceinline__ float kx(float d2) {\n"
         "  return SCALED ? kexp(d2) : expf(-fmaxf(d2, 0.f));\n}\n\n" + _TILE_STEP, 1),
        ("= kexp(nav[h]", "= kx<SCALED>(nav[h]", 4)],
        "K9's ks-pass entries by expf"),
}


def variant_sources(out: Path) -> dict:
    """{variant: its source file} for the variants whose edits all match,
    written under ``out``; exits naming the first edit that does not."""
    files = {}
    for name, (fname, edits, _) in VARIANTS.items():
        text = (CSRC / fname).read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                sys.exit(f"finish_repairs: {name}: an edit matches "
                         f"{text.count(old)} times in {fname}, not {count}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / fname).write_text(text)
        files[name] = d / fname
    return files


class Overlay:
    """A variant's library in front of the package's: its entry points,
    with the package's C signatures, and the package's for the rest."""

    def __init__(self, so, base, build):
        self._so, self._base, self._sigs = so, base, build._SIGNATURES

    def __getattr__(self, name):
        try:
            fn = getattr(self._so, name)
        except AttributeError:
            return getattr(self._base, name)
        fn.argtypes, fn.restype = self._sigs[name]
        return fn


def build_all(files: dict, build) -> dict:
    """{variant: Overlay}: one nvcc a variant, all started together."""
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(f.with_suffix(".so")), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, f in files.items()}
    base = build.lib()
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"finish_repairs: {name}: nvcc failed:\n{log[-4000:]}")
        out[name] = Overlay(ctypes.CDLL(str(files[name].with_suffix(".so"))), base, build)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    out_dir = ROOT / "build" / "finish_repairs"
    files = variant_sources(out_dir)
    if args.dry:
        print(f"finish_repairs: every edit applies; sources under {out_dir}")
        return
    if not torch.cuda.is_available():
        sys.exit("finish_repairs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build_all(files, _build)
    saved = _build._LIB
    rows = {}
    try:
        for patch in (5, 7):
            cfg, _, noisy, plan = cs.make_workload_8mp(gt, patch=patch)
            x = cs.fused_inputs(cfg, plan, torch.as_tensor(noisy, device=dev), dev)
            s64 = cs.ext2_recompute_f64(*x.k8)[1][:x.n]
            u_p = k79.ext2_matvec_plain(*x.k8)[0][:x.p]
            for rep in range(args.reps):
                for name, lib in libs.items():
                    _build._LIB = lib
                    row = rows.setdefault(f"{name}, patch {patch}", dict(
                        design=VARIANTS[name][2], lanes=x.ctx.f_t.shape[0],
                        k8_ms=[], k9_ms=[]))
                    row["k8_ms"].append(cs.cuda_ms(lambda: k79.ext2_matvec_cuda(*x.k8), 5))
                    row["k9_ms"].append(cs.cuda_ms(
                        lambda: k79.finish_colstats_cuda(*x.k9), 3))
                    if rep == 0:
                        u, s = k79.ext2_matvec_cuda(*x.k8)
                        row["k8_s_vs_f64"] = cs.signed_stats(s[:x.n], s64, True)
                        row["k8_u_vs_plain"] = cs.signed_stats(u[:x.p], u_p, True)
                        row["k9_parts"] = cs.k9_parts(k79, x.k9, x.n)
                        del u, s
                    print(f"{name}, patch {patch}: {row}", flush=True)
            del x, s64, u_p
            torch.cuda.empty_cache()
    finally:
        _build._LIB = saved
    result = dict(card=card, variants=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
