"""The f32 K3/K4 (csrc/strip_sweeps.cu sandwich_split_kernel: each f32
operand in three bf16 parts on wgmma) as shipped and in other designs, at
config 2's f32 shapes (chip_smoke.make_workload_f32: P 5248, N 262144, kp
256), on one CUDA card.

    python3 scripts/f32_sandwich_designs.py [--only NAMES] [--reps N]
                                            [--parent DIR] [--out FILE]
                                            [--dry]

Variants of the shipped kernel, each a copy of strip_sweeps.cu with its
text edited, built alone under build/f32_sandwich_designs/<variant>/ (one
nvcc a variant, all at once, scripts/finish_repairs.build_all) and put in
front of the package's library while it runs:

* ``one accumulator`` — each stage's a0 b0 products accumulate on top of
  the five correction products (the shipped kernel sums a0 b0 from zero,
  exact on the parts' grids, and adds it to the running sum by itself);
* ``fst2`` — two f32 strip tiles in flight instead of four;
* ``no convert`` (timing only) — the converter splits nothing: the parts
  in shared memory are stale, the loads, barriers and products as shipped;
* ``no mma`` (timing only) — the consumers issue no wgmma: loads,
  conversion and barriers alone.

With ``--parent DIR`` (a checkout unpacked there, e.g. the parent commit
with ``git archive``), that checkout's strip_sweeps.cu is built alone too
and its glt_strip_sandwich_f32 called with the FFMA tile's interface (ws
f32, sketch tiles of 128 columns, two blocks an SM, 16-deep stages): the
design this kernel replaced, timed beside it on the same inputs.

The inputs are chip_smoke.strip_cases' (K3: ta, t, s_pre, b_mask; K4: ta,
s2; a seeded generator) on the path's own f32 strip. For each design and
turn (--reps, default 2, the designs in turn: parent, shipped, ...,
shipped, parent): K3's and K4's times (CUDA events, chip_smoke.cuda_ms);
on the first turn their largest error over max |plain| (chip_smoke's TOL
is 1e-4), their error against the sums in f64 relative to the f64 sum of
the magnitudes of u's terms (K ((K^T |ta|) s2): max and p99, beside the
plain f32 version's), and their lean against the f64 sums (share below,
chip_smoke.signed_stats). The plain version's and the cuBLAS composition's
times (chip_smoke.strip_library) once. --dry writes the variant sources
and checks the edits without a card. Prints the card line and one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
OUT = ROOT / "build" / "f32_sandwich_designs"

_BIG = "            wgmma_n128<TA>(acc, da(0, kk), db(0, kk), kk);\n"
_ADD = "        for (int i = 0; i < 64; ++i) run[h][i] += acc[i];\n"
_KK = "        for (int kk = 0; kk < SS_BK / 16; ++kk) {\n          if (chain == 0) {"
ONE_ACC = [(_BIG, "            wgmma_n128<TA>(acc, da(0, kk), db(0, kk), 1);\n"),
           (_ADD, "        if (chain == 1)\n" + _ADD)]
FST2 = [("constexpr int SS_FST = 4;", "constexpr int SS_FST = 2;")]
NO_CONVERT = [("      ss_convert<PHASE, SPOST>(smem + fs * SS_F_BYTES,",
               "      if (nk < 0) ss_convert<PHASE, SPOST>(smem + fs * SS_F_BYTES,")]
NO_MMA = [(_KK, _KK.replace("kk < SS_BK / 16;", "kk < SS_BK / 16 && nk < 0;")),
          (_ADD, "        for (int i = 0; i < 64; ++i) run[h][i] += nk < 0 ? acc[i] : 0.f;\n")]

# name -> (edits of strip_sweeps.cu, what)
VARIANTS = {
    "shipped": ([], "shipped: the corrections, then a0 b0, two chains a half"),
    "one accumulator": (ONE_ACC, "a0 b0 on top of the corrections, one sum a half"),
    "fst2": (FST2, "two f32 strip tiles in flight instead of four"),
    "no convert": (NO_CONVERT, "timing only: no split (stale parts)"),
    "no mma": (NO_MMA, "timing only: no wgmma"),
}


def variant_sources(out: Path, parent: str = "", only=None) -> dict:
    """{variant: its strip_sweeps.cu} under ``out`` (and ``parent``'s as
    "parent ffma"); exits naming the first edit that does not match the
    shipped source exactly once."""
    src = (CSRC / "strip_sweeps.cu").read_text()
    files = {}
    todo = dict(VARIANTS)
    if parent:
        todo["parent ffma"] = (None, "the FFMA tile (sandwich_f32_kernel)")
    for name, (edits, _) in todo.items():
        if only and name not in only:
            continue
        base = CSRC
        text = src
        if edits is None:
            base = Path(parent) / "graphlap_tpu_torch" / "csrc"
            text = (base / "strip_sweeps.cu").read_text()
        for old, new in edits or []:
            if text.count(old) != 1:
                sys.exit(f"f32_sandwich_designs: {name}: an edit does not match once:\n{old}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "mma_common.cuh").write_text((base / "mma_common.cuh").read_text())
        (d / "strip_sweeps.cu").write_text(text)
        files[name] = d / "strip_sweeps.cu"
    return files


class ParentFfma:
    """The replaced design's entry point with its own interface, called
    through the package's wrapper: ws f32 (N, kp), no ta parts, sketch
    tiles of 128 columns, the FFMA tile's split plan."""

    def __init__(self, so, base):
        self._fn = so.glt_strip_sandwich_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        self._fn.argtypes = [p] * 10 + [i] * 5 + [p]
        self._fn.restype = i
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)


def parent_call(k24, fn, strip, ta, t, s_pre, bm, s2):
    """K3 (t given) or K4 through the FFMA tile's interface."""
    from graphlap_tpu_torch.ops import _build

    p, n = strip.shape
    kp = ta.shape[1]
    kp2 = -(-kp // 128) * 128
    dev = strip.device
    tab = torch.zeros((p, kp2), device=dev)
    tab[:, :kp] = ta
    splits = k24.sandwich_splits(p, n, kp2, k24._sms(strip), 128, 2, 16)
    ws = torch.empty((n, kp2), device=dev)
    part = torch.empty((splits, p, kp2), device=dev)
    u = torch.empty((p, kp2), device=dev)
    s_post = torch.empty(n, device=dev)
    ptrs = [None if x is None else x.contiguous().data_ptr() for x in (t, s_pre, bm, s2)]
    rc = fn(strip.data_ptr(), tab.data_ptr(), *ptrs, s_post.data_ptr(), ws.data_ptr(),
            part.data_ptr(), u.data_ptr(), p, n, n, kp2, splits, _build.stream_ptr(strip))
    _build.check(rc, "parent ffma")
    return (u[:, :kp], s_post) if t is not None else u[:, :kp]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--parent", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    only = [s.strip() for s in args.only.split(",") if s.strip()] or None
    files = variant_sources(OUT, args.parent, only)
    if args.dry:
        print(f"f32_sandwich_designs: {len(files)} variant sources under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("f32_sandwich_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    load = importlib.util.spec_from_file_location
    spec = load("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spec = load("finish_repairs", ROOT / "scripts" / "finish_repairs.py")
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_strip as k24

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    cs.EXP_RATE = 1e12              # strip_cases' bounds are not reported here
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = fr.build_all(files, _build)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if "parent ffma" in libs:
        libs["parent ffma"] = ParentFfma(libs["parent ffma"]._so, _build.lib())
    cfg, _, noisy, plan = cs.make_workload_f32(gt)
    ctx = ms._strip_ctx(torch.as_tensor(noisy, device=dev),
                        torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg)
    cases, _, library = cs.strip_cases(ctx, cfg, dev)
    p = ctx.p
    names = ("strip_sandwich_spost_f32", "strip_sandwich_f32")
    args_of = {k: cases[k][2] for k in names}
    strip = ctx.strip_pad
    del ctx, cases

    ref, rows = {}, {}
    for k in names:
        a = args_of[k]
        plain = (k24.strip_sandwich_spost_plain(*a)[0] if k.startswith("strip_sandwich_spost")
                 else k24.strip_sandwich_plain(*a))
        if k.startswith("strip_sandwich_spost"):
            s2_64 = (a[3].double() / torch.clamp(a[2].double() @ strip.double(), min=1e-30)
                     * a[4].double())
        else:
            s2_64 = a[2].double()
        kb = strip.double()
        u64 = (kb @ ((kb.T @ a[1].double()) * s2_64[:, None]))[:p]
        scale = (kb @ ((kb.T @ a[1].double().abs()) * s2_64[:, None]))[:p]
        del kb
        torch.cuda.empty_cache()
        ref[k] = (plain, u64, scale)
        lib_fn = library[k][0]
        rows[k] = dict(plain_ms=cs.cuda_ms(lambda: (
            k24.strip_sandwich_spost_plain if k.startswith("strip_sandwich_spost")
            else k24.strip_sandwich_plain)(*a), 2),
            library_ms=cs.cuda_ms(lambda: lib_fn(*a), 3), designs={})

    def f64_err(x, k):
        _, u64, scale = ref[k]
        e = ((x[:p].double() - u64).abs() / scale.clamp_min(1e-300)).flatten()
        return float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))

    for k in names:
        pl = f64_err(ref[k][0], k)
        rows[k]["plain_f64_max"], rows[k]["plain_f64_p99"] = pl
        print(f"{k}: plain {rows[k]['plain_ms']:.3f} ms, cuBLAS composition "
              f"{rows[k]['library_ms']:.3f} ms; plain f32 against f64: max {pl[0]:.3e}, "
              f"p99 {pl[1]:.3e}", flush=True)

    saved = _build._LIB
    try:
        for rep in range(args.reps):
            for name in (list(libs) if rep % 2 == 0 else list(libs)[::-1]):
                _build._LIB = libs[name]
                for k in names:
                    a = args_of[k]
                    if name == "parent ffma":
                        spost = len(a) == 5
                        call = (lambda a=a, fn=libs[name]._fn, spost=spost: parent_call(
                            k24, fn, a[0], a[1], *(a[2:5] if spost else (None, None, None)),
                            None if spost else a[2]))
                    else:
                        call = (lambda a=a, k=k: (k24.strip_sandwich_spost_cuda(*a)
                                                  if len(a) == 5 else k24.strip_sandwich_cuda(*a)))
                    row = rows[k]["designs"].setdefault(
                        name, dict(what=VARIANTS.get(name, (None, "the FFMA tile"))[1], ms=[]))
                    if "err" not in row:
                        got = call()
                        got = got[0] if isinstance(got, tuple) else got
                        torch.cuda.synchronize()
                        plain = ref[k][0]
                        row["err"] = float((got[:p] - plain[:p]).abs().max()
                                           / plain[:p].abs().max())
                        row["f64_max"], row["f64_p99"] = f64_err(got, k)
                        st = cs.signed_stats(got[:p].double(), ref[k][1], False)
                        row["share_below_f64"] = st["share_below"]
                        again = call()
                        again = again[0] if isinstance(again, tuple) else again
                        row["repeat_bits"] = bool(torch.equal(got, again))
                        del got, again
                    row["ms"].append(cs.cuda_ms(call, 5))
                    print(f"{k} [{name}]: {row['ms'][-1]:.3f} ms; err {row['err']:.3e} over "
                          f"max |plain|; against f64 max {row['f64_max']:.3e}, p99 "
                          f"{row['f64_p99']:.3e}; share below f64 "
                          f"{row['share_below_f64']:.4f}; repeat {row['repeat_bits']}",
                          flush=True)
                    torch.cuda.empty_cache()
    finally:
        _build._LIB = saved
    out = dict(card=card, shapes=dict(p_pad=int(strip.shape[0]), n=int(strip.shape[1]),
                                      kp=int(args_of[names[1]][1].shape[1])),
               rows=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
