"""K1 (csrc/affinity_strip.cu) and K2 (csrc/strip_sweeps.cu) in the designs
their header notes compare, at config 2's shapes: time and error against
the plain version.

    python3 scripts/strip_designs.py [--out build/strip_designs.json]
                                     [--dry]

The kernel library holds one design of each. This script copies the sources
into build/strip_designs/<variant>/, rewrites the lines a variant changes
(each edit must match the shipped source exactly once), builds each copy
with the package's own nvcc recipe and loads it in place of the package's
library. Variants of K2: the partials exchanged through a cluster barrier
and distributed-shared-memory reads instead of pushed (``barrier``); each
slab's rows staged in 8-row TMA boxes, all issued by one thread, instead of
one 3-D box (``boxes8``); 256 threads a block instead of 512
(``threads256``); the three together (``first``, the design this kernel
started from); and, for timing only, neither sweep (``nosweeps``: the slab
loads, the exchange and the barriers alone). K2's launch plans (cluster
size, slabs in flight) run on the shipped library at P = 5248 (config 2)
and P = 8192 (the sample cap, a random strip). Variants of K1: the exp as
ex2.approx.ftz (subnormal entries flushed), the row-tile loop unrolled by
2, the corrections in two mma chains, and, for timing only, no store, no
exp, no mma. Times are CUDA-event means (chip_smoke.cuda_ms), each variant
run twice in turn. --dry writes the variant sources and checks the edits
without a card. Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
OUT = ROOT / "build" / "strip_designs"

_SW2_FROM = ("      const int r = rfirst + X2_RSTEP * i;\n"
             "      if (r >= R) break;\n      float x[E];")
K2_BARRIER = [
    ("      part[tid] = acc;\n",
     "      part[tid] = acc;\n      rq[rank * 2 * W + tid] = acc;\n"),
    ("    if (tid == 0) mbar_expect_tx(rbar, (uint32_t)(C * 2 * W * 4));\n",
     ""),
    ("""    if (tid < C * (W / 2)) {
      const int dst = tid / (W / 2), f4 = tid % (W / 2);
      x2_send(x2_mapa(smem_u32(rq + rank * 2 * W + 4 * f4), dst),
              reinterpret_cast<const float4*>(part)[f4], x2_mapa(rbar, dst));
    }
""", "    cluster.sync();\n"),
    ("      mbar_wait_cluster(rbar, (q >> 1) & 1);\n", ""),
    ("""        kbr += rq[rk * 2 * W + tid];
        kbc += rq[rk * 2 * W + W + tid];""",
     """        const float* px = cluster.map_shared_rank(rq + rk * 2 * W, rk);
        kbr += px[tid];
        kbc += px[W + tid];"""),
]
_LOAD_END = """      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(0), "r"(row0 / 8), "r"(bar)
      : "memory");"""
K2_BOXES8 = [
    (_LOAD_END, _LOAD_END + """
  for (uint32_t g = 1; g < bytes / 1024; ++g)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\\n" ::"r"(dst + 1024 * g),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(0), "r"(row0 / 8 + (int)g),
        "r"(bar)
        : "memory");"""),
    ("const cuuint32_t box[3] = {(cuuint32_t)x2_w<T>(), 8, (cuuint32_t)rows / 8}",
     "const cuuint32_t box[3] = {(cuuint32_t)x2_w<T>(), 8, 1}"),
]
K2_THREADS256 = [
    ("constexpr int X2_THREADS = 512;", "constexpr int X2_THREADS = 256;"),
    ("constexpr int X2_MAXR = 16;", "constexpr int X2_MAXR = 32;"),
]
K2_NOSWEEPS = [
    (_SW2_FROM, _SW2_FROM.replace("if (r >= R) break;", "if (r >= 0) break;")),
    ("for (int r = rfirst; r < R; r += X2_RSTEP) {",
     "for (int r = R; r < R; r += X2_RSTEP) {"),
]
K1_NOMMA = [
    ("""          mma16816h(h[ks], ab[ks], bb[nt][ks][0], bb[nt][ks][1]);""",
     """          h[ks][ks & 3] = __uint_as_float(ab[ks][ks & 3] ^ bb[nt][ks][ks & 1]);"""),
    ("""          mma16816h(cr, ab[ks], bsm[nt][ks][0], bsm[nt][ks][1]);
          mma16816h(cr, as[ks], bb[nt][ks][0], bb[nt][ks][1]);""",
     """          cr[ks] += __uint_as_float(as[ks][2] ^ bsm[nt][ks][1]);"""),
]
K1_TWOCHAINS = [
    ("        float h[KS][4], cr[4] = {0.f, 0.f, 0.f, 0.f};",
     "        float h[KS][4], cr[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};"),
    ("          mma16816h(cr, as[ks], bb[nt][ks][0], bb[nt][ks][1]);",
     "          mma16816h(cq, as[ks], bb[nt][ks][0], bb[nt][ks][1]);"),
    ("          const float cross = big + cr[e];",
     "          const float cross = big + (cr[e] + cq[e]);"),
]
_STORE = ("        tma_store(&out_map, smem_u32(stage + bx * A1_BOX), "
          "ct * A1_TN + bx * BOX_COLS, rb * A1_TM);")
K1_NOSTORE = [(_STORE, "        if (rb < 0)\n  " + _STORE[2:])]
K1_NOEXP = [("          v[e] = BF16_OUT ? kexp(d2) : expf(-fmaxf(d2, 0.f));",
             "          v[e] = d2;")]
K1_FTZ = [('asm("ex2.approx.f32 %0, %1;\\n"', 'asm("ex2.approx.ftz.f32 %0, %1;\\n"')]
K1_UNROLL2 = [("#pragma unroll 1\n    for (int ml = 0;",
               "#pragma unroll 2\n    for (int ml = 0;")]


def _on(src: str, edits) -> list:
    return [(src, *e) for e in edits]


# name -> (kernel, [(source, old, new)], what)
VARIANTS = {
    "k2 shipped": ("strip_ext2", [], "shipped"),
    "k2 barrier": ("strip_ext2", _on("strip_sweeps.cu", K2_BARRIER),
                   "partials through a cluster barrier and DSMEM reads"),
    "k2 boxes8": ("strip_ext2", _on("strip_sweeps.cu", K2_BOXES8),
                  "8-row TMA boxes, issued by one thread"),
    "k2 threads256": ("strip_ext2", _on("strip_sweeps.cu", K2_THREADS256),
                      "256 threads a block"),
    "k2 first": ("strip_ext2",
                 _on("strip_sweeps.cu", K2_BARRIER + K2_BOXES8 + K2_THREADS256),
                 "barrier + 8-row boxes + 256 threads"),
    "k2 nosweeps": ("strip_ext2", _on("strip_sweeps.cu", K2_NOSWEEPS),
                    "timing only: loads, exchange and barriers, no sweep"),
    "k1 shipped": ("affinity_strip", [], "shipped"),
    "k1 ftz": ("affinity_strip", _on("mma_common.cuh", K1_FTZ),
               "exp as ex2.approx.ftz"),
    "k1 unroll2": ("affinity_strip", _on("affinity_strip.cu", K1_UNROLL2),
                   "row-tile loop unrolled by 2"),
    "k1 twochains": ("affinity_strip", _on("affinity_strip.cu", K1_TWOCHAINS),
                     "corrections in two mma chains"),
    "k1 nostore": ("affinity_strip", _on("affinity_strip.cu", K1_NOSTORE),
                   "timing only: no store"),
    "k1 noexp": ("affinity_strip", _on("affinity_strip.cu", K1_NOEXP),
                 "timing only: no exp"),
    "k1 nomma": ("affinity_strip", _on("affinity_strip.cu", K1_NOMMA),
                 "timing only: no mma"),
}
# K2's launch plans (cluster, slabs in flight) on the shipped library
PLANS = {5248: [(8, 2), (8, 1), (16, 2), (16, 4)],
         8192: [(16, 3), (16, 2), (8, 1)]}


def write_variant(name: str, edits) -> Path:
    """The sources with a variant's edits under build/strip_designs/."""
    out = OUT / name.replace(" ", "_")
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    texts = {f.name: f.read_text() for f in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]}
    for src, old, new in edits:
        if texts[src].count(old) != 1:
            sys.exit(f"strip_designs: {name}: an edit of {src} does not match once:\n{old}")
        texts[src] = texts[src].replace(old, new)
    for fname, text in texts.items():
        (out / "csrc" / fname).write_text(text)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "strip_designs.json"))
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    dirs = {name: write_variant(name, edits) for name, (_, edits, _) in VARIANTS.items()}
    if args.dry:
        print(f"strip_designs: {len(dirs)} variant sources written under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("strip_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg, _, noisy, plan = cs.make_workload(gt)
    ctx = ms._strip_ctx(torch.as_tensor(noisy, device=dev),
                        torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg)
    feats_a = torch.full((ctx.strip_pad.shape[0], ctx.feats_a.shape[1]), 1e3, device=dev)
    feats_a[:ctx.p] = ctx.feats_a
    gen = torch.Generator(device=dev).manual_seed(1)
    t2 = torch.zeros((2, ctx.strip_pad.shape[0]), device=dev)
    t2[:, :ctx.p] = 0.5 + torch.rand((2, ctx.p), generator=gen, device=dev)
    cases = {"affinity_strip": (k1.affinity_strip_cuda,
                                (feats_a, ctx.feats_pad, torch.float32, torch.bfloat16)),
             "strip_ext2": (k24.strip_ext2_cuda, (ctx.strip_pad, t2, ctx.b_mask))}
    refs = {"affinity_strip": k1.affinity_strip_plain(*cases["affinity_strip"][1]),
            "strip_ext2": k24.strip_ext2_plain(*cases["strip_ext2"][1])}

    def err(got, ref):
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        return max(float((g.float() - r.float()).abs().max() / r.float().abs().max())
                   for g, r in pairs)

    saved = _build.CSRC, _build.BUILD_DIR, _build._LIB
    rows = {}
    try:
        libs = {}
        for name, out in dirs.items():          # build each once
            _build.CSRC, _build.BUILD_DIR, _build._LIB = out / "csrc", out, None
            libs[name] = (_build.lib(), out)
        for rep in range(2):
            for name, (kernel, _, what) in VARIANTS.items():
                _build._LIB = libs[name][0]
                fn, kargs = cases[kernel]
                got = fn(*kargs)
                row = rows.setdefault(name, dict(design=what, ms=[], err=err(got, refs[kernel])))
                del got
                row["ms"].append(cs.cuda_ms(lambda: fn(*kargs), 10))
                print(f"{name} ({what}): {row['ms'][-1]:.3f} ms, err {row['err']:.2e}",
                      flush=True)
        _build._LIB = libs["k2 shipped"][0]
        lib = _build._LIB
        for p, plans in PLANS.items():
            if p == ctx.strip_pad.shape[0]:
                strip, tt, bm = cases["strip_ext2"][1]
            else:
                g = torch.Generator(device=dev).manual_seed(p)
                strip = (torch.rand((p, ctx.n_pad), generator=g, device=dev) ** 4).to(
                    torch.bfloat16)
                tt = 0.5 + torch.rand((2, p), generator=g, device=dev)
                bm = torch.ones(ctx.n_pad, device=dev)
            n = strip.shape[1]
            ref = k24.strip_ext2_plain(strip, tt, bm)
            t2b = tt.to(torch.bfloat16).contiguous()
            for cl, stages in plans:
                clusters = min(lib.glt_ext2_strip_clusters(cl, p // cl, stages), -(-n // 64))
                s = torch.empty(n, device=dev)
                u_part = torch.empty((clusters, p), device=dev)
                u = torch.empty(p, device=dev)

                def go():
                    _build.check(lib.glt_strip_ext2(
                        strip.data_ptr(), t2b.data_ptr(), bm.data_ptr(), s.data_ptr(),
                        u_part.data_ptr(), u.data_ptr(), p, n, n, cl, stages, clusters,
                        _build.stream_ptr(strip)), "strip_ext2 plan")
                go()
                row = dict(clusters=clusters, err=err((u, s), ref),
                           ms=[cs.cuda_ms(go, 10), cs.cuda_ms(go, 10)],
                           shipped=k24.ext2_plan(p) == k24.Ext2Plan(
                               cl, p // cl, stages, k24.ext2_smem(p // cl, stages, cl)))
                rows[f"k2 plan P={p} cluster={cl} stages={stages}"] = row
                print(f"K2 P={p} cluster {cl} stages {stages}: {row}", flush=True)
            del strip
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = saved
    out = dict(card=card, shapes=dict(p_pad=int(ctx.strip_pad.shape[0]), n=int(ctx.n_pad)),
               variants=rows)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
