"""On-card smoke run of graphlap_tpu_torch: every ported path on one NVIDIA
GPU, through its hand-written CUDA kernels.

    python3 chip_smoke.py

Phases (each prints a line with its wall; any failure raises and exits
non-zero before the last line is printed):

1. device   — CUDA must be available; prints the card's name and power limit.
2. build    — compiles graphlap_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
              process a source, all started together; the K3/K4 kernels'
              SASS (cuobjdump -sass) must hold HGMMA, Hopper's wgmma, on
              both strip types (the f32 ones with no FFMA tile left), and
              the K1 and K7 emitters', K8's, K9's ks pass's, the V
              pass's and the aug and f32 K5/K6 kernels' HMMA at 32, 64, 96
              and 128 lanes (their products on the tensor cores), and the
              f32 K9/K10 kernel's at all ten instantiations, with no FFMA
              V or ks pass left; the coordinate K5/K6 kernel
              (coord_tile_kernel, one for every lane count) must be built
              and spill nothing (its registers printed from -Xptxas -v);
              the f32 K8 (ext2_f32_tile_kernel, two instantiations) must be
              built and at least one of its clusters fit the card (its
              registers, spills and resident clusters x blocks at p_pad
              4096 printed).
3. config 2 — the strip_cache path (bench.make_workload's recipe: 512x512
              test image, noise sigma 0.1 seed 1, CONFIG2 + strip_cache,
              kernels, sketch o206 p0):
   kernels  K1-K4 at the path's shapes (p=5243 padded to 5248 rows,
            N=512*512, bf16 strip, sketch width 256), each against its
            plain PyTorch version on the card, timed with CUDA events,
            beside a cuBLAS composition of the same function (their
            library yardstick); K2-K4 launched once more on the same inputs
            (the two runs must agree bit for bit); K2's lean (u on the
            sample rows, s on the columns) and K3/K4's (u) — the share of
            the outputs below the plain version's sums in f64, signed, with
            its mean and median; the f32 plain version's own lean beside
            it — are required in (0.25, 0.75);
   e2e      filter_image: one warm-up and three timed runs with the launch
            counts set to 0 just before them, peak memory, PSNR in/out; the
            same factor through the plain versions on the card (image and
            eigenvalues within 0.05 dB, 2e-2); a 96x96
            image on the card against the plain versions on the CPU.
3b. config 2 f32 — the same recipe with its f32 strip kept (affinity_dtype
              "float32": tuned_config(CONFIG2, 512*512, "fast",
              keep={"affinity_dtype"})):
   kernels  K1's f32 store and the f32 K2-K4 at the path's shapes on its
            own features and strip (5248 x 262144, 5.5 GB), as config 2's:
            against their plain versions, timed beside f32 cuBLAS
            compositions, launched twice bit for bit, K2-K4's leans against
            their sums in f64 required; K3/K4's u against their f64 sums
            over the f64 sum of its terms' magnitudes, max and p99 within
            1.5x the plain version's, lean required, on the case's ta, on
            it with its columns scaled by 2^+-16 and its rows by 2^+-3,
            and on the path's own operands (recorded from one filter_image
            call, their octaves printed); K3/K4's bound counts six bf16
            tensor passes (three bf16 parts an operand), the f32 FFMA bound
            printed beside; K1's row is kept in the phase's record (its
            kernels-line row is the dense phase's);
   e2e      filter_image: K1 (f32 store), K2, K3, K4 once a call, gain
            > 5 dB, kernel vs plain path on the image and the eigenvalues
            (0.02 dB, 2e-3); staged on the same recipe held to filter_image
            (0.02 dB, 2e-3); 96x96 card vs CPU plain (0.02 dB, 2e-3).
3c. config 1 fast — tuned_config(CONFIG1, 512*512, "fast"): strip_cache on
              gaussian + (row, col) / 8 features, bf16 store:
   kernels  K1's coordinate cross and the bf16 K2-K4 at the path's shapes
            (2688 x 262144) on its own features and strip, as config 2's
            (against plain, timed beside their compositions, K2-K4 twice bit
            for bit and their leans required); K2-K4's rows are kept in the
            phase's record (their kernels-line rows are config 2's);
   e2e      filter_image: K1 (coordinate cross), K2, K3, K4 once a call,
            kernel vs plain path on the image and the eigenvalues (0.05 dB,
            2e-2), PSNR printed (the recipe degenerates in the reference
            too: no gain required); 96x96 card vs CPU plain (0.05 dB,
            2e-2).
3d. config 2 at 7x7, 9x9 and 11x11 — make_workload(gt, patch): config 2's
              recipe with an NLM 7x7, 9x9 or 11x11 patch (the CLI's
              -patch), 49, 81 or 121 feature lanes:
   kernels  K1's 64-, 96- or 128-lane instantiation, bf16 and f32 stores
            (rows *_d64, *_d96, *_d128), on the path's own features into
            its strip's shape (5248 x 262144, poisoned pad rows), against
            their plain versions, timed beside their cuBLAS composition,
            launched twice bit for bit (K2-K4 take the strip as at 5x5: no
            feature axis);
   e2e      filter_image: K1, K2, K3, K4 once a call, gain > 5 dB at 7x7,
            > 3 dB at 9x9 and 11x11 (the reference gains 5.07 and 4.72 dB
            at 256^2), kernel vs plain path on the image and the
            eigenvalues (0.05 dB, 2e-2); 96x96 card vs CPU plain; then the
            recipe with its f32 strip kept (make_workload_f32 at the patch,
            the f32 store's path): K1 f32 and the f32 K2-K4 once a call,
            the same gain, 0.02 dB / 2e-3 from its plain path.
4. config 4 — the recompute-streaming fused-finish path (benchmarks/run.py's
              cfg4_8mp_compliant_turbo_p1: 2048x4096 test image, sigma 0.1
              seed 1, p=4096, m=50, bf16 tiles, coarse Sinkhorn and gram
              1/64, one polish, LOBPCG):
   kernels  K7-K9 at the path's 8 MP shapes on its own features and
            layouts, scale vectors from a seeded generator, each against
            its plain version on the card, timed with CUDA events (K7, K8
            and K9 launched once more on the same inputs: the two runs must
            agree bit for bit; K10 likewise in config 4t); K7 beside a
            cuBLAS composition of its function (library_ms) and the gram
            GEMM that follows it on the path; K8's u and s
            once more apart, with the mean, median and share below zero of
            u's signed row errors (required in (0.25, 0.75)); K8's s lean
            against the f64 sums of the same bf16 tile entries and K9's V
            lean are required in the same band; K9's V error in two parts,
            its s against the plain s (and the share of columns whose
            bf16(s) differs) and its V against the plain V formed from its
            own s;
   e2e-8mp  filter_image: one warm-up and three timed runs (counts set to 0
            just before), walls, peak memory, PSNR in/out, launches;
   plain    the same factor through the plain versions on the card;
   small    96x96 on the recompute recipe of tests/test_torch_recompute.py,
            card kernels against CPU plain versions, same LOBPCG start.
4b. config 4 at 7x7 — make_workload_8mp_p7: the same recipe with an NLM 7x7
              patch, bf16 aug tiles of 55 lanes padded to 64: phase 4 on the
              64-lane K7, K8 and K9 (rows *_d64: against plain, timed,
              twice bit for bit, K8's u and s and K9's V leans required,
              K9's V error apart, K7, K8,
              K9 once a call, gain > 1 dB, 0.05 dB / 2e-2 from the plain
              path, 96x96 vs the CPU); then phase 7 (the turbo recipe) at
              7x7, K10's path: the 64-lane K10 against plain, its V lean
              required, K7 and K10 once a call, gain > 1 dB, plain path,
              96x96. The same two phases at 9x9 and 11x11 (rows *_d96 and
              *_d128: bf16 aug tiles of 87 and 127 lanes padded to 96 and
              128; K8's entries from kb_pair in place of its table).
5. config 3 — the recompute matvec route, bf16 aug layout (benchmarks/run.py's
              cfg3_1024_rgb_sharpen: 1024x1024 RGB test image, noise sigma
              0.03 seed 3, tuned_config(CONFIG3, "fast"): per-channel
              sharpen 0.15 by exact matvecs, p=4096, bf16 tiles, coarse
              Sinkhorn 1/8 + one polish):
   table    the aug entry at every one of the 65536 bf16(d2) patterns,
            evaluated (kb_aug), through the K5/K6 kernel's table lookup and
            through K7's entry (kexp on bf16(d2)), on the card: no pattern
            may differ; the live range read off the
            evaluated entries and the patterns where K10's exp (one FMUL, one
            MUFU ex2) would differ are printed beside;
   kernels  K5/K6 at channel 0's shapes (p_pad 4096, N 1048576), positive
            vectors from a seeded generator, each against its plain version
            (launched once more on the same inputs: the two runs must agree
            bit for bit, as for the f32 K5/K6 of config 4q), and each
            output's lean, (kernel - plain) / plain: mean, median and share
            below zero, and against the f64 sums of the same bf16 entries
            (the w product on the FP32 pipe at every depth), both required
            in (0.25, 0.75);
   e2e      filter_image: warm-up and three timed runs, walls, peak memory,
            launches per call (6 / 6), the reference's config-3 quality bars
            (gradient-energy ratio, SSIM, PSNR);
   plain    the same three channels through the plain versions on the card;
   small    a 48x48x3 image, card kernels against CPU plain versions.
5b. config 3 at 7x7, 9x9 and 11x11 — make_workload_cfg3 with an NLM 7x7,
              9x9 or 11x11 patch (the CLI's -patch), bf16 aug tiles of 55, 87
              or 127 lanes padded to 64, 96 or 128: phase 5 on the 64-, 96-
              or 128-lane aug K5/K6 (rows *_d64, *_d96, *_d128: against
              plain, twice bit for bit, leans required, timed beside their
              bound), the path end to end (6 / 6 launches a call, the three
              sharpen bars, which the reference meets at each patch,
              scripts/reference_quality.py --recipes 3p9 3p11; 0.05 dB /
              2e-2 from the plain path, 48x48x3 vs the CPU).
6. config 4q — the 8 MP matvec denoise, f32 plain layout (benchmarks/run.py's
              cfg4_8mp_quality_matvec: denoise_tuned(h 0.1) + "fast": identity
              W y, f32 features and tiles, coarse Sinkhorn 1/64 + one polish):
   kernels  K5/K6 (f32) at the 8 MP shapes against their plain versions,
            timed beside a cuBLAS composition of the same function (f32
            GEMM at "highest" over column chunks, the norms, the clamp,
            exp, the product with v or t; also the coordinate K5/K6's
            yardstick), with their lean as in config 3 and against their
            f64 sums
            (both required); their max and p99 relative error against the
            f64 sums within 1.5x the plain version's, and their share below
            them in (0.35, 0.65) (the three-part split cross);
   e2e-8mp  walls, peak memory, launches per call (2 / 2), PSNR gain > 5 dB;
   plain    the same channel through the plain versions on the card
            (0.02 dB, 2e-3);
   small    the recipe at 96x96, card kernels against CPU plain versions
            (0.02 dB, 2e-3).
6b. config 4q at 7x7, 9x9 and 11x11 — make_workload_8mp_matvec with an
              NLM 7x7, 9x9 or 11x11 patch, f32 tiles of 49, 81 or 121 lanes
              padded to 64, 96 or 128: phase 6 on the 64-, 96- or 128-lane
              f32 K5/K6 (rows *_d64, *_d96, *_d128; the 5 dB gain, which
              the reference shows at each patch, scripts/reference_quality.py
              --recipes 4qp9 4qp11).
7. config 4t — the 8 MP turbo recipe on the unfused spectral schedule
              (benchmarks/run.py's cfg4_8mp_turbo_sc64_gc64: config 4's image
              and sample, coarse Sinkhorn and gram 1/64, no polish, so no
              fused finish):
   kernels  K10 (colstats + V) at the path's 8 MP shapes against its plain
            version, V's lean ((kernel - plain) sign(plain), required), and
            the share of one 64-row stage's bf16 tile entries whose exp
            (one FMUL, one MUFU ex2) differs from bf16(expf);
   e2e-8mp  filter_image: warm-up and three timed runs, walls, peak memory,
            launches per call (K7 1, K10 1, K8/K9 0), PSNR gain > 1 dB;
   plain    the same channel through the plain versions on the card;
   small    96x96 on the turbo recipe's shape, card against CPU plain.
8. staged   — filter_image_staged (the unfused schedule, a wall per stage) on
              config 4's cfg4_8mp_compliant_turbo_p1 (K5/K6 polish, K7, K10),
              on the same recipe at 7x7 and 11x11 (make_workload_8mp: the
              64- and 128-lane aug K5/K6 polish, K7 and K10) and on config
              2 (K1 once a stage), each held to filter_image on the same
              config within the bf16 bars; at 7x7 and 11x11, where the
              reference's fused and unfused schedules part too, to the same
              stages through the plain versions on the card (its gap to
              filter_image printed).
9. dense    — the dense (non-streaming) path on bench.py's f32 twin of the
              headline, CONFIG2.replace(use_pallas=True) at 512x512 (noise
              sigma 0.1 seed 1; p=5243, the (p, N-p) K_AB strip stored f32,
              20 full-resolution Sinkhorn iterations, LOBPCG, m=50):
   kernels  K1 at the dense shape (K_AB: 5243 x 256901 in permuted [A; B]
            order, ragged, so the kernel writes padded rows and returns the
            view): the f32 store against its plain version (5e-5), timed
            beside its cuBLAS composition, two launches bit for bit; the
            bf16 store the same way, within one bf16 ulp;
   e2e      filter_image: warm-up and three timed runs (counts set to 0 just
            before), walls, peak memory, PSNR in/out (gain > 5 dB), one K1
            launch a call, the kernel path against the plain path (0.02 dB,
            2e-3); the same at affinity_dtype="bfloat16_store" (0.05 dB,
            2e-2);
   staged   filter_image_staged on the f32 twin: four stage walls
            (affinity, normalize, eigensolve, filter), held to filter_image
            within 2e-3;
   small    config 1 at 128x128 and config 2 dense at 96x96, card against
            the plain versions on the CPU (0.02 dB, 2e-3).
10. bilateral — the 8 MP bilateral denoise (tuned_config(CONFIG1.replace(
              streaming=True, sample_cap=4096), 2048*4096, "fast"): gaussian
              + (row, col) / 8, f32 features and tiles, coarse Sinkhorn and
              gram 1/64, one polish, fused finish, LOBPCG) on config 4's
              image:
   kernels  K7-K10 f32 and the coordinate K5/K6 at the path's 8 MP shapes
            on its own layouts (the lanes K5/K6 and K8 read printed), each
            against its plain version (K7's entries to a gross 0.25,
            K9/K10's sums to 2e-4, K8's and K5/K6's to gross 1e-2 / 0.1:
            their norms round apart), timed, K7, K8 and K5/K6 beside their
            cuBLAS compositions, K7's f32 gram GEMM after it, two
            launches bit for bit, the leans of K8's u and s, K9's and K10's
            V and K5/K6's outputs (ties left out) required in (0.25, 0.75);
   slab     each f32 kernel's tile (and K1's and K6's coordinate cross)
            against f64 on slabs of the path's features, the kernel's max
            and p99 |dK| at most 1.5x the plain f32 version's; the split
            cross printed beside; K8's u and s, K5/K6's outputs, and K9's
            V and s and K10's V (on 2^20 of the columns, V over its terms'
            magnitudes) against their f64 sums under the same rule, K9's
            and K10's shares below f64 required in (0.25, 0.75); the f32
            K9/K10's bounds count V and ks as six bf16 tensor passes beside
            the FFMA cross, the all-FFMA bound printed beside;
   e2e      filter_image: warm-up and three timed runs, walls, peak memory,
            K8, K7, K9 once a call and K10 never, PSNR (printed: the
            recipe's spectrum degenerates in the reference too), the
            kernel path against the plain path (0.02 dB, 2e-3);
   staged   filter_image_staged: stage walls, K5/K6 (coordinate cross), K7
            and K10 once a call;
   small    the recipe written out at 96x96, fused finish on and off, card
            kernels against CPU plain versions (0.02 dB, 2e-3).
10b. config 2 bilateral at 7x7, 9x9 and 11x11 — recipe A,
              make_workload_cfg2_bilateral(gt, patch): tuned_config(
              CONFIG2.replace(patch_size=patch, spatial_h=8.0), 512*512,
              "fast"), an NLM patch and (row, col) / 8: 51, 83 or 123
              lanes, 52, 84 or 124 live of 64, 96 or 128; as phase 3c: K1's
              coordinate cross (affinity_strip_coord_d64, _d96, _d128) on
              the path's features into its strip (against plain, timed
              beside its composition, twice bit for bit; past 7x7 also
              against f64 on 512 sample rows by every pixel, max and p99
              |dK| within 1.5x the plain version's), the bf16 K2-K4 on its
              strip kept
              in the record at 7x7, filter_image (K1, K2, K3, K4 once a
              call), the plain path and the eigenvalues (0.05 dB, 2e-2),
              PSNR printed (the recipe loses PSNR in the reference too),
              at 11x11 filter_image_staged held to filter_image (0.05 dB,
              2e-2), 96x96 vs the CPU.
10e. cli — graphlap_tpu_torch.cli.main as a user runs it, on the clean
              512x512 test image saved as a PNG: (i) recipe A at 11x11
              (-kernel nlm -patch 11 -spatial_h 8 -sample 0.02 -preset
              fast -noise 0.1 -seed 1 -log_view -json_log -o): the record's
              config_hash that of make_workload_cfg2_bilateral(gt, 11), K1
              once in each of the two stages that build the strip, the
              output PNG within 2e-2 + 1/255 of filter_image on the same
              noised image and its PSNR within 0.05 dB; (ii) the dense
              route (-pallas) at 9x9 and 11x11: K1's coordinate cross with
              the f32 store at the K_AB shape (5243 x 256901; rows
              affinity_strip_coord_f32_d96, _d128) against plain, twice bit
              for bit, timed beside its composition, against f64 on 512
              sample rows, then the CLI run: rc 0, one K1 launch, the wall
              and the PSNR printed.
10c. bilateral NLM 8 MP — recipe B, make_workload_8mp_nlm_bilateral:
              phase 10 with an NLM 7x7 patch (h 0.15, 52 live lanes of 64,
              rows *_d64), and first its kernel rows alone at NLM 5x5 (28
              live lanes of 32, the kernels' LV = 32 instantiations: the
              same checks, kept in the phase's record); then recipe C
              (10d) at 7x7; then both again at 9x9 and 11x11 (84 and 124
              live lanes of 96 and 128, rows *_d96 and *_d128, K1's
              coordinate cross among the slabs; the staged schedule held
              to its own plain path; the 96x96 run of recipe B at 11x11
              only).
10d. bilateral NLM 8 MP matvec — recipe C, make_workload_8mp_nlm_bilateral_
              matvec (denoise_tuned(0.1)): the coordinate K5/K6 at the
              patch's depth twice a call through filter_image, PSNR printed
              (the recipe degenerates in the reference too), the plain path
              (0.02 dB, 2e-3, or 1.5x the plain path's own f32 floor),
              96x96 vs the CPU.
11. result  — one JSON line listing every kernel and layout (76 rows:
              name, route, source, replaces, launches, max_abs_err, ms,
              plain_ms, bound_ms, bound_by, library_ms) after the line with
              the run's total seconds, the card line, then the contract line
              {"ok": true, "device": {...}}.

Needs one CUDA card and the CUDA toolkit; imports neither JAX nor the JAX
package. Extra detail (nvcc's register report, all numbers) goes to
build/chip_smoke/chip_smoke.json and build/chip_smoke/ptxas.txt.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H = W = 512
H3 = W3 = 1024
H8, W8 = 2048, 4096
RUNS = 3
LIBRARY_REPS = 1   # timed calls of the f32 K5/K6's and K8's cuBLAS compositions
# the card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its least bytes over the memory rate and its
# operations over the peak of their type
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12   # bf16 = fp16
# the exp rate: one MUFU ex2 result a lane, 16 a clock an SM (Hopper's
# special-function units), times the SMs and the card's max SM clock
# (read from nvidia-smi in main). Where the exp's argument is an f32 value
# (K1, K9, K10, the f32 K5/K6) the function needs one exp a tile entry,
# entries / EXP_RATE; the aug-layout entry bf16(exp(-bf16(max(d2, 0))))
# of K7, K8 and the bf16 K5/K6 is a function of a 16-bit value, which a
# table gives without an exp (K8 reads one), so their bound has no exp term
MUFU_PER_CLOCK = 16
EXP_RATE = None
# kernel vs plain tolerances at the paths' shapes: absolute for bf16 tiles
# with entries in [0, 1] (K1, K7), else relative to max|plain|
TOL = {
    # bf16 store: the kernel's split-fp16 cross moves d2 by a few f32 ulps
    # of the norms (as the plain version's own f32 product does), which can
    # flip a stored value by one bf16 ulp (2^-8 below 1.0)
    "affinity_strip": 2.0 ** -8,
    # f32 store (the dense path's K_AB): the same d2 movement through an
    # IEEE expf, absolute (entries in [0, 1]); the bar of the f32 K1 tests
    "affinity_strip_f32": 5e-5,
    # f32 sums in another order over P=5248 rows / N=262144 columns
    "strip_ext2": 1e-4,
    # as K2, plus ws re-rounded to bf16 where the f32 sums straddle a
    # rounding boundary (one ulp, 2^-8 relative, on a few entries)
    "strip_sandwich_spost": 2e-3,
    "strip_sandwich": 2e-3,
    # the tensor-core f32 sum order moves the aug d2 in its last bits, so
    # bf16(d2) can flip a tile entry by one ulp; the product with bf16(cols)
    # rounds once more: two bf16 ulps (2^-7) absolute
    "kb_strip": 2.0 ** -7,
    # the same tile flips, summed over 4096 rows and 8.4M columns in
    # another f32 order (the reference test's bf16 bar for this kernel)
    "ext2_matvec": 2e-2,
    # K9 rounds s_j to bf16 before the V product: where ks sums in another
    # f32 order, bf16(s_j) can land on the other neighbour and scale a whole
    # V row by one bf16 ulp (2^-8), and tile entries of the row flip as in
    # K8 — two bf16 ulps (2^-7) of max |V| at 8.4M rows (the reference's
    # 5e-3 bar holds at its 2048-column test shape); norms and coeffs are
    # checked against their sums of term magnitudes
    "finish_colstats": 2.0 ** -7,
    # K5/K6 aug: a tile entry flips one bf16 ulp where the tensor-core d2
    # sums in another f32 order (as K8), and the sums over 1M columns /
    # 4096 rows run in another order; each flip moves a sum by ~2^-8 / 1e3
    "matvec": 1e-3,
    "rmatvec": 1e-3,
    # K5/K6 f32: the same f32 tile values, the cross in another FMA order
    # (d2 moves by ~1e-6 of |f|^2) and the sums of 8.4M / 4096 terms in
    # another order (~sqrt(terms) f32 ulps)
    "matvec_f32": 1e-4,
    "rmatvec_f32": 1e-4,
    # K10 rounds the same bf16(c_j) as its plain version, so only the tile
    # entries flip (one bf16 ulp where the tensor-core cross sums in another
    # f32 order, as K8/K9) and the sums over 4096 rows run in another order:
    # K9's 2^-7 of max |V|, without its bf16(s_j) term; norms and coeffs
    # against their sums of term magnitudes
    "colstats_v": 2.0 ** -7,
    # f32 layouts on the bilateral recipe's coordinate features (|f|^2 up to
    # ~3.3e5 at 8 MP): two correct f32 evaluations of na + nb - 2 cross in
    # another order differ by the f32 cancellation error itself, up to ~0.07
    # in an entry (a numpy emulation against f64), times cols <= 1.5 on both:
    # 0.25 absolute on K7's entries is only a gross-error bar; the bar of
    # the tile is the f64 slab (within 1.5x the plain version's error)
    "kb_strip_f32": 0.25,
    # K9 / K10 take the f32 norms passed in, as their plain versions do, so
    # only the cross's f32 order differs: the sums to 2e-4 of max |plain|
    # (norms and coeffs to their term magnitudes)
    "finish_colstats_f32": 2e-4,
    "colstats_v_f32": 2e-4,
    # K8 and the coordinate K5/K6 form their norms as FMA chains, the plain
    # versions as sums of rounded squares: at |f|^2 ~ 3.3e5 one f32 ulp of
    # a norm is 0.03 in d2, which moves every entry of its row (column) by
    # 3% together. Against the plain version these bars catch only gross
    # errors (u sums thousands of live entries, 1e-2; K6's outputs a few
    # sample rows, 0.1); the bar of the sums is their f64 evaluation, within
    # 1.5x the plain version's error (sums_f64_check)
    "ext2_matvec_f32": 1e-2,
    "matvec_coord": 0.1,
    "rmatvec_coord": 0.1,
    # K2-K4 on config 2's f32 strip (the "highest" class): the same f32
    # operands, sums over P=5248 rows / N=262144 columns in another order,
    # and no rounding point that could flip (ws stays f32; K3/K4's products
    # of three bf16 parts are f32-exact); K3/K4's bar of the sums is their
    # f64 evaluation, within 1.5x the plain version's error
    # (sandwich_f64_checks)
    "strip_ext2_f32": 1e-4,
    "strip_sandwich_spost_f32": 1e-4,
    "strip_sandwich_f32": 1e-4,
    # K1's IEEE f32 cross on config 1's coordinate features, bf16 store:
    # the kernel's FFMA chain and the plain f32 product round d2 apart by
    # the cancellation error of |f|^2 up to ~1.6e4 at 512^2 (an f32 ulp
    # there is 2e-3), which moves an entry by up to ~2^-8 of itself before
    # the store rounds it: two bf16 ulps (2^-7) absolute
    "affinity_strip_coord": 2.0 ** -7,
    # the 64-lane instantiations (an NLM 7 x 7 patch, 49 lanes) on config 2
    # and config 4 at 7 x 7: the split cross over 64 lanes stays under
    # 2^-13 of 2^(Ea + Eb) (tests/test_torch_kernels.py, re-derived from
    # the lane count), a few f32 ulps of the norms in d2 as at 32 lanes, so
    # K1 keeps its bars; K7-K10 round at the same points as at 32 lanes
    # with a d2 chain twice as long, so they keep theirs
    "affinity_strip_d64": 2.0 ** -8,
    "affinity_strip_f32_d64": 5e-5,
    "kb_strip_d64": 2.0 ** -7,
    "ext2_matvec_d64": 2e-2,
    "finish_colstats_d64": 2.0 ** -7,
    "colstats_v_d64": 2.0 ** -7,
    # K5/K6 at 64 lanes (an NLM 7 x 7 patch: config 3's sharpen on the aug
    # layout, the 8 MP matvec denoise on the f32 one): the same rounding
    # points as at 32 lanes, with a d2 chain over four k16 steps (aug) and
    # the split cross over 64 lanes (f32; its bar, L 2^-19 of 2^(Ea + Eb),
    # re-derived from the lane count in tests/test_torch_matvec.py), so
    # they keep the 32-lane bars
    "matvec_d64": 1e-3,
    "rmatvec_d64": 1e-3,
    "matvec_f32_d64": 1e-4,
    "rmatvec_f32_d64": 1e-4,
    # the f32 K7-K10, the coordinate K5/K6 and K1's coordinate cross at 64
    # lanes (an NLM 7 x 7 patch and the coordinates, 52 live; recipes A-C):
    # the same rounding points as at 4 and 28 live lanes, the cross a longer
    # FFMA chain over the same |f|^2 (the coordinates' ~3.3e5 at 8 MP,
    # ~1.6e4 at 512^2; the patch lanes P / (h 7) add under 50), so they
    # keep those rows' bars; their bar against the f64 slabs and sums is
    # again 1.5x the plain version's error
    "kb_strip_f32_d64": 0.25,
    "finish_colstats_f32_d64": 2e-4,
    "colstats_v_f32_d64": 2e-4,
    "matvec_coord_d64": 0.1,
    "rmatvec_coord_d64": 0.1,
    "affinity_strip_coord_d64": 2.0 ** -7,
    # K1's coordinate cross at 96 and 128 lanes (recipe A at 9 x 9 and 11 x
    # 11 and the CLI's dense -pallas route: an NLM patch and the
    # coordinates, 84 or 124 live): the same rounding points as at 64
    # lanes, a longer FFMA chain over the same 512^2 coordinates (|f|^2 ~
    # 1.6e4; the patch lanes add under 130), so the bf16 store keeps the
    # 64-lane row's two bf16 ulps; the f32 store (the dense K_AB) moves by
    # the same d2 rounding through an IEEE expf, held to that bar as a gross
    # check: its bar is the f64 slab (within 1.5x the plain version's error)
    "affinity_strip_coord_d96": 2.0 ** -7,
    "affinity_strip_coord_d128": 2.0 ** -7,
    "affinity_strip_coord_f32_d96": 2.0 ** -7,
    "affinity_strip_coord_f32_d128": 2.0 ** -7,
    # K8 f32 on the NLM bilateral recipe: its s_j = bm_j / sqrt(kbt_r
    # kbt_c), and one column's norm rounded apart moves all its entries by
    # e^(d2 error) together (0.03 a norm ulp at |f|^2 ~ 3.3e5), so s_j by
    # the same factor: several % of s_j, where max |s| sits on the columns
    # farthest from the samples (NLM 5 x 5 measured 2.1e-2 of max |s|). As
    # K5/K6's 0.1, a gross bar; its sums' bar is their f64 evaluation
    "ext2_matvec_f32_d64": 0.1,
    # the bf16 layouts at 96 and 128 lanes (NLM 9 x 9 and 11 x 11: 81 and
    # 121 lanes, the aug layout's 87 and 127) on configs 2 and 4 and the
    # turbo at 9 x 9 and 11 x 11: the same rounding points as at 64 lanes,
    # with longer d2 chains (K7-K10; K8's entry kb_pair's, equal to the
    # table's at every bf16(d2) pattern) and the split cross over more lanes
    # (K1; its f32 store split in three parts past 64 lanes), so each keeps
    # its 64-lane bar
    "affinity_strip_d96": 2.0 ** -8,
    "affinity_strip_d128": 2.0 ** -8,
    "affinity_strip_f32_d96": 5e-5,
    "affinity_strip_f32_d128": 5e-5,
    "kb_strip_d96": 2.0 ** -7,
    "kb_strip_d128": 2.0 ** -7,
    "ext2_matvec_d96": 2e-2,
    "ext2_matvec_d128": 2e-2,
    "finish_colstats_d96": 2.0 ** -7,
    "finish_colstats_d128": 2.0 ** -7,
    "colstats_v_d96": 2.0 ** -7,
    "colstats_v_d128": 2.0 ** -7,
    # K5/K6 at 96 and 128 lanes (config 3's sharpen and the 8 MP matvec
    # denoise at 9 x 9 and 11 x 11): the same rounding points as at 64
    # lanes, with d2 chains over six or eight k16 steps (aug; the entry from
    # the same table at 96 lanes, from kb_pair at 128, equal at every
    # bf16(d2) pattern; the w product exact on the FP32 pipe) and the split
    # cross over more lanes (f32; its bar, L 2^-19 of 2^(Ea + Eb),
    # re-derived from the lane count in tests/test_torch_matvec.py), so they
    # keep the 64-lane bars
    "matvec_d96": 1e-3,
    "rmatvec_d96": 1e-3,
    "matvec_d128": 1e-3,
    "rmatvec_d128": 1e-3,
    "matvec_f32_d96": 1e-4,
    "rmatvec_f32_d96": 1e-4,
    "matvec_f32_d128": 1e-4,
    "rmatvec_f32_d128": 1e-4,
    # the f32 K7-K10 and the coordinate K5/K6 at 96 and 128 lanes (an NLM 9
    # x 9 or 11 x 11 patch and the coordinates, 84 or 124 live; recipes B
    # and C): the same rounding points as at 64 lanes, the cross a longer
    # FFMA chain over the same coordinates' |f|^2 (the patch lanes add under
    # 130), so they keep the 64-lane rows' bars; their bar against the f64
    # slabs and sums is again 1.5x the plain version's error
    "kb_strip_f32_d96": 0.25,
    "kb_strip_f32_d128": 0.25,
    "ext2_matvec_f32_d96": 0.1,
    "ext2_matvec_f32_d128": 0.1,
    "finish_colstats_f32_d96": 2e-4,
    "finish_colstats_f32_d128": 2e-4,
    "colstats_v_f32_d96": 2e-4,
    "colstats_v_f32_d128": 2e-4,
    "matvec_coord_d96": 0.1,
    "matvec_coord_d128": 0.1,
    "rmatvec_coord_d96": 0.1,
    "rmatvec_coord_d128": 0.1,
    # the same kernels at 28 live lanes (NLM 5 x 5 and the coordinates: the
    # LV = 32 instantiations, recipe B's twin) keep the 64-lane rows' bars;
    # rows kept in the phase's record, not in the kernels line
    "kb_strip_f32_l28": 0.25,
    "ext2_matvec_f32_l28": 0.1,
    "finish_colstats_f32_l28": 2e-4,
    "colstats_v_f32_l28": 2e-4,
    "matvec_coord_l28": 0.1,
    "rmatvec_coord_l28": 0.1,
}
REPLACES = {
    "affinity_strip": "graphlap_tpu/ops/pallas_affinity.py:76",
    "affinity_strip_f32": "graphlap_tpu/ops/pallas_affinity.py:76",
    "strip_ext2": "graphlap_tpu/ops/pallas_streaming.py:940",
    "strip_sandwich_spost": "graphlap_tpu/ops/pallas_streaming.py:1045",
    "strip_sandwich": "graphlap_tpu/ops/pallas_streaming.py:1110",
    "kb_strip": "graphlap_tpu/ops/pallas_streaming.py:319",
    "ext2_matvec": "graphlap_tpu/ops/pallas_streaming.py:554",
    "finish_colstats": "graphlap_tpu/ops/pallas_streaming.py:677",
    "matvec": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec": "graphlap_tpu/ops/pallas_streaming.py:447",
    "matvec_f32": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec_f32": "graphlap_tpu/ops/pallas_streaming.py:447",
    "colstats_v": "graphlap_tpu/ops/pallas_streaming.py:817",
    "kb_strip_f32": "graphlap_tpu/ops/pallas_streaming.py:319",
    "ext2_matvec_f32": "graphlap_tpu/ops/pallas_streaming.py:554",
    "finish_colstats_f32": "graphlap_tpu/ops/pallas_streaming.py:677",
    "colstats_v_f32": "graphlap_tpu/ops/pallas_streaming.py:817",
    "matvec_coord": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec_coord": "graphlap_tpu/ops/pallas_streaming.py:447",
    "strip_ext2_f32": "graphlap_tpu/ops/pallas_streaming.py:940",
    "strip_sandwich_spost_f32": "graphlap_tpu/ops/pallas_streaming.py:1045",
    "strip_sandwich_f32": "graphlap_tpu/ops/pallas_streaming.py:1110",
    "affinity_strip_coord": "graphlap_tpu/ops/pallas_affinity.py:76",
    "affinity_strip_d64": "graphlap_tpu/ops/pallas_affinity.py:76",
    "affinity_strip_f32_d64": "graphlap_tpu/ops/pallas_affinity.py:76",
    "kb_strip_d64": "graphlap_tpu/ops/pallas_streaming.py:319",
    "ext2_matvec_d64": "graphlap_tpu/ops/pallas_streaming.py:554",
    "finish_colstats_d64": "graphlap_tpu/ops/pallas_streaming.py:677",
    "colstats_v_d64": "graphlap_tpu/ops/pallas_streaming.py:817",
    "matvec_d64": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec_d64": "graphlap_tpu/ops/pallas_streaming.py:447",
    "matvec_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:447",
    "kb_strip_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:319",
    "ext2_matvec_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:554",
    "finish_colstats_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:677",
    "colstats_v_f32_d64": "graphlap_tpu/ops/pallas_streaming.py:817",
    "matvec_coord_d64": "graphlap_tpu/ops/pallas_streaming.py:397",
    "rmatvec_coord_d64": "graphlap_tpu/ops/pallas_streaming.py:447",
    "affinity_strip_coord_d64": "graphlap_tpu/ops/pallas_affinity.py:76",
    "affinity_strip_coord_f32": "graphlap_tpu/ops/pallas_affinity.py:76",
}
SOURCE = {
    "affinity_strip": "graphlap_tpu_torch/csrc/affinity_strip.cu",
    "affinity_strip_f32": "graphlap_tpu_torch/csrc/affinity_strip.cu",
    "strip_ext2": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich_spost": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "kb_strip": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "ext2_matvec": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "finish_colstats": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "matvec": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "matvec_f32": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec_f32": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "colstats_v": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "kb_strip_f32": "graphlap_tpu_torch/csrc/coord_store.cu",
    "ext2_matvec_f32": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "finish_colstats_f32": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "colstats_v_f32": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "matvec_coord": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec_coord": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "strip_ext2_f32": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich_spost_f32": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "strip_sandwich_f32": "graphlap_tpu_torch/csrc/strip_sweeps.cu",
    "affinity_strip_coord": "graphlap_tpu_torch/csrc/coord_store.cu",
    "affinity_strip_d64": "graphlap_tpu_torch/csrc/affinity_strip.cu",
    "affinity_strip_f32_d64": "graphlap_tpu_torch/csrc/affinity_strip.cu",
    "kb_strip_d64": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "ext2_matvec_d64": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "finish_colstats_d64": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "colstats_v_d64": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "matvec_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "matvec_f32_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec_f32_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "kb_strip_f32_d64": "graphlap_tpu_torch/csrc/coord_store.cu",
    "ext2_matvec_f32_d64": "graphlap_tpu_torch/csrc/recompute_sweeps.cu",
    "finish_colstats_f32_d64": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "colstats_v_f32_d64": "graphlap_tpu_torch/csrc/colstats_v.cu",
    "matvec_coord_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "rmatvec_coord_d64": "graphlap_tpu_torch/csrc/recompute_matvec.cu",
    "affinity_strip_coord_d64": "graphlap_tpu_torch/csrc/coord_store.cu",
    "affinity_strip_coord_f32": "graphlap_tpu_torch/csrc/coord_store.cu",
}
# the f32 kernels on coordinate features (recipes B and C)
COORD_ROWS = ("kb_strip_f32", "ext2_matvec_f32", "finish_colstats_f32",
              "colstats_v_f32", "matvec_coord", "rmatvec_coord")
WIDE = tuple(f"{k}_d{fd}" for fd in (96, 128) for k in (
    "affinity_strip", "affinity_strip_f32", "kb_strip", "ext2_matvec",
    "finish_colstats", "colstats_v", "matvec", "rmatvec", "matvec_f32",
    "rmatvec_f32", "affinity_strip_coord", "affinity_strip_coord_f32")
    + COORD_ROWS)                          # the rows past 64 lanes
for _name in WIDE:
    _base = _name.rsplit("_d", 1)[0]
    REPLACES[_name], SOURCE[_name] = REPLACES[_base], SOURCE[_base]
NAMES = [n for n in TOL if not n.endswith("_l28")]   # rows of the kernels line
# kernels whose cross-block sums must repeat bit for bit (fixed-order
# partials, no float atomics): checked by a second launch on the same inputs
BIT_REPEAT = ("affinity_strip_f32", "strip_ext2", "strip_sandwich_spost",
              "strip_sandwich", "kb_strip", "ext2_matvec", "matvec",
              "rmatvec", "matvec_f32", "rmatvec_f32", "finish_colstats",
              "colstats_v", "kb_strip_f32", "ext2_matvec_f32",
              "finish_colstats_f32", "colstats_v_f32", "matvec_coord",
              "rmatvec_coord", "strip_ext2_f32", "strip_sandwich_spost_f32",
              "strip_sandwich_f32", "affinity_strip_d64",
              "affinity_strip_f32_d64", "kb_strip_d64", "ext2_matvec_d64",
              "finish_colstats_d64", "colstats_v_d64", "matvec_d64",
              "rmatvec_d64", "matvec_f32_d64", "rmatvec_f32_d64",
              "kb_strip_f32_d64", "ext2_matvec_f32_d64",
              "finish_colstats_f32_d64", "colstats_v_f32_d64",
              "matvec_coord_d64", "rmatvec_coord_d64",
              "affinity_strip_coord_d64", "kb_strip_f32_l28",
              "ext2_matvec_f32_l28", "finish_colstats_f32_l28",
              "colstats_v_f32_l28", "matvec_coord_l28",
              "rmatvec_coord_l28") + WIDE
# kernels whose entries lie in [0, 1] (K1, K7): checked absolute, see TOL
ABSOLUTE = ("affinity_strip", "affinity_strip_f32", "kb_strip",
            "kb_strip_f32", "affinity_strip_coord", "affinity_strip_d64",
            "affinity_strip_f32_d64", "kb_strip_d64", "kb_strip_f32_d64",
            "affinity_strip_coord_d64", "kb_strip_f32_l28") + tuple(
                n for n in WIDE if n.startswith(("affinity", "kb_strip")))
# the f32 kernels on coordinate features, whose sums often tie their plain
# version's bit for bit: their leans leave the ties out (signed_stats)
UNTIED = tuple(f"{k}{sfx}" for sfx in ("", "_d64", "_d96", "_d128", "_l28")
               for k in COORD_ROWS[1:])
# the band a required signed line's share below zero must lie in
SIGNED_BAND = (0.25, 0.75)
# the f32 K3/K4 run each product as six bf16 tensor passes (each operand in
# three bf16 parts, six of the nine part products kept)
F32_SANDWICH_PASSES = 6
# so do the f32 K9 / K10's V and ks (the tile entries and B = [gr | t] in
# three bf16 parts each)
F32_V_PASSES = 6
OUT = Path("build") / "chip_smoke"


# the feature lanes of an NLM patch's layouts: the plain layout's d and the
# aug layout's d + 6 pad to the same depth at every patch the CLI takes
PATCH_LANES = {5: 32, 7: 64, 9: 96, 11: 128}


def lanes_sfx(lanes: int) -> str:
    """A kernel row's suffix for its layout's feature depth: none at 32
    lanes, ``_d64``, ``_d96`` or ``_d128`` past it."""
    return "" if lanes == 32 else f"_d{lanes}"


def phase(name: str, msg: str, t0: float | None = None) -> None:
    wall = "" if t0 is None else f" [{time.perf_counter() - t0:.1f} s]"
    print(f"[{name}] {msg}{wall}", flush=True)


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


def max_rel_err(got, ref, scales=None) -> tuple[float, list]:
    """(max |got - ref| over paired outputs, each output's max |got - ref|
    over its scale: max |ref|, or the given scale tensor elementwise)."""
    err, rels = 0.0, []
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        require(g.shape == r.shape, f"shape {g.shape} != {r.shape}")
        require(bool(torch.isfinite(g).all()), "non-finite kernel output")
        e = (g - r).abs()
        err = max(err, float(e.max()))
        if scales is not None and scales[i] is not None:
            rels.append(float((e / scales[i].clamp_min(1e-30)).max()))
        else:
            rels.append(float(e.max()) / max(float(r.abs().max()), 1e-30))
    return err, rels


def colstats_scales(y):
    """K9's and K10's error scales: max |ref| for V and s; for norms and
    coeffs, the sums of their terms' magnitudes (sum_j V_jm^2,
    sum_j |y_j V_jm|), the scale of an f32 sum's order error — coeffs
    cancel (V takes both signs), so max |coeffs| would measure the
    cancellation, not the kernel."""
    def scales(ref):
        v = ref[0]
        return (None, torch.sum(v * v, dim=0), torch.abs(y) @ torch.abs(v),
                None)
    return scales


def bound(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0,
          exps: float = 0.0):
    """(bound_ms, bound_by): the least time for the same work on this
    card: bytes over the memory rate, or the operations of the busiest
    type (16-bit tensor, f32, exp) over its rate."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(bf16_flops / PEAK_BF16, f32_flops / PEAK_F32,
                exps / EXP_RATE)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def signed_stats(got, ref, per_entry: bool, ties: bool = True) -> dict:
    """Which side of its plain version an output leans to: r = (got - ref)
    sign(ref) over |ref| (per_entry) or over max |ref|, on the entries where
    ref != 0. Tile entries that flip and another sum order scatter r both
    ways; an accumulation that rounds toward zero pulls |got| low on every
    entry, so the share below zero nears 1. An f64 reference is compared in
    f64: rounded to f32 it would tie many f32 outputs exactly, and a tie
    counts as not below. With ``ties`` False the tied entries are left out
    of the share (and their share is reported): the f32 kernels' sums of
    a few live terms equal the plain version's on most entries, which say
    nothing of a lean."""
    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    g, r = got.to(dt).flatten(), ref.to(dt).flatten()
    keep = r != 0
    g, r = g[keep], r[keep]
    d = (g - r) * torch.sign(r)
    d = d / (r.abs() if per_entry else r.abs().max())
    out = dict(mean=float(d.mean()), median=float(d.median()),
               entries=d.numel())
    if not ties:
        out["tied"] = float((d == 0).float().mean())
        d = d[d != 0]
    out["share_below"] = float((d < 0).float().mean())
    return out


def lean_specs(spec) -> list:
    """A kernel's signed lines: one (output index, entries kept, per_entry,
    required[, reference]) tuple, or a list of them."""
    return spec if isinstance(spec, list) else [spec]


def run_cases(cases: dict, rows: dict, signed: dict | None = None,
              library: dict | None = None) -> None:
    """Each kernel against its plain version, then both timed. ``signed``
    names the kernels whose lean is printed: {name: (output index, entries
    kept, per_entry, required[, reference]), or a list of them, one a signed
    output (output i > 0 printed as name[i])}; a required one fails the run
    unless its share below lies in SIGNED_BAND. The lean is taken against
    the plain version, or against ``reference`` (the same arguments) where
    given, whose own lean against the plain version is printed beside it.
    ``library``: {name: (fn, what[, reps])}, one cuBLAS composition
    computing the kernel's function on the same arguments, timed as its
    yardstick (over ``reps`` calls, 5 unless given)."""
    for name, (kern, plain, args, bnd, *scale_fn) in cases.items():
        t0 = time.perf_counter()
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        pair = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for idx, keep, per_entry, required, *lean_ref in lean_specs(
                (signed or {}).get(name, [])):
            label = name if idx == 0 else f"{name}[{idx}]"
            base, against = pair[1][idx], "plain"
            if lean_ref:
                r64 = lean_ref[0](*args)
                base = (r64 if not isinstance(r64, tuple) else r64[idx])
                against = "plain in f64"
                st_p = signed_stats(pair[1][idx][:keep], base[:keep],
                                    per_entry)
                phase("signed", f"{label}: the plain version itself against "
                      f"{against}: mean {st_p['mean']:.3e}, median "
                      f"{st_p['median']:.3e}, share below "
                      f"{st_p['share_below']:.4f}")
                rows.setdefault("signed_plain", {})[label] = st_p
                del r64
            st = signed_stats(pair[0][idx][:keep], base[:keep], per_entry,
                              ties=name not in UNTIED)
            del base
            tied = (f" (ties left out: {st['tied']:.4f} of them)"
                    if "tied" in st else "")
            phase("signed", f"{label}: (kernel - {against}) sign({against}) / "
                  f"{'|ref|' if per_entry else 'max |ref|'} over "
                  f"{st['entries']} outputs: mean {st['mean']:.3e}, median "
                  f"{st['median']:.3e}, share below {st['share_below']:.4f}"
                  f"{tied}"
                  f"{f' (required in {SIGNED_BAND})' if required else ''}")
            seen = rows.setdefault("signed", {})
            seen[label if label not in seen else f"{label} vs {against}"] = st
            if required:
                require(SIGNED_BAND[0] < st["share_below"] < SIGNED_BAND[1],
                        f"{label}: biased to one side of its {against}")
        scales = scale_fn[0](ref) if scale_fn else None
        err, rels = max_rel_err(*pair, scales)
        rel = max(rels)
        if name in ABSOLUTE:
            rel = err                                 # absolute, see TOL
        if name in BIT_REPEAT:
            again = kern(*args)
            again = again if isinstance(again, tuple) else (again,)
            require(all(torch.equal(a, b) for a, b in zip(pair[0], again)),
                    f"{name}: two launches on the same inputs differ")
            del again
        del got, ref, scales, pair
        ms_k = cuda_ms(lambda: kern(*args), 5)
        ms_p = cuda_ms(lambda: plain(*args), 2)
        ms_l, lib_what = None, None
        if library and name in library:
            lib_fn, lib_what, *lib_reps = library[name]
            ms_l = cuda_ms(lambda: lib_fn(*args), (lib_reps or [5])[0])
        b_ms, b_by = bnd
        lib_txt = "" if ms_l is None else f", library {ms_l:.3f} ms"
        phase("kernel", f"{name}: max_abs_err {err:.3e} (checked {rel:.3e}"
              f" = max of {[f'{r:.2e}' for r in rels]}, "
              f"tol {TOL[name]:.1e}); kernel {ms_k:.3f} ms, plain {ms_p:.3f} "
              f"ms{lib_txt}, bound {b_ms:.3f} ms ({b_by})", t0)
        if lib_what:
            phase("library", f"{name}: yardstick {lib_what}")
        require(rel <= TOL[name], f"{name} disagrees with its plain version")
        rows[name] = dict(max_abs_err=err, rel_err=rel, ms=ms_k, plain_ms=ms_p,
                          bound_ms=b_ms, bound_by=b_by, library_ms=ms_l,
                          library=lib_what)
        torch.cuda.empty_cache()


def drive(gt, noisy, cfg, plan, dev, counters, tag):
    """filter_image: a warm-up, then RUNS timed calls with every count set
    to 0 just before them. Returns (result, walls, peak bytes, launches)."""
    gt.filter_image(noisy, cfg, plan=plan, device=dev)          # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        res = gt.filter_image(noisy, cfg, plan=plan, device=dev)
        walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, c in launches.items():
        require(c > 0, f"{name}: the {tag} path never launched its kernel")
    return res, walls, peak, launches


def noisy_image(gt, h, w):
    img = gt.make_test_image(h, w)
    noisy = np.ascontiguousarray(
        np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1), np.float32)
    return img, noisy


def make_workload(gt, patch=5):
    """bench.make_workload's recipe, rebuilt on the port, with an NLM
    ``patch`` x ``patch`` patch (config 2's 5): (cfg, clean image, noisy f32
    image, plan)."""
    cfg = gt.CONFIG2.replace(streaming=True, strip_cache=True,
                             block_cols=H * W, use_pallas=True,
                             affinity_dtype="bfloat16_store",
                             sinkhorn_iters=6, solver="sketch",
                             sketch_oversample=206, sketch_power=0,
                             sinkhorn_coarse=16, sinkhorn_polish=1,
                             patch_size=patch)
    img, noisy = noisy_image(gt, H, W)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_p7(gt):
    """Config 2 at 7 x 7: bench.make_workload's recipe with patch_size=7
    (the CLI's -patch 7): 49 feature lanes, K1's 64-lane split cross."""
    return make_workload(gt, patch=7)


def make_workload_f32(gt, patch=5):
    """Config 2 with its f32 strip kept: bench.make_workload's recipe with
    affinity_dtype="float32", which is tuned_config(CONFIG2, 512*512,
    "fast", keep={"affinity_dtype"}) (checked), at an NLM ``patch``:
    (cfg, clean image, noisy f32 image, plan)."""
    cfg = make_workload(gt, patch)[0].replace(affinity_dtype="float32")
    require(cfg == gt.tuned_config(gt.CONFIG2.replace(patch_size=patch),
                                   H * W, "fast", keep={"affinity_dtype"}),
            "the f32 recipe is not config 2's fast preset with its f32 kept")
    img, noisy = noisy_image(gt, H, W)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_cfg2_bilateral(gt, patch=7):
    """Recipe A, config 2 with an NLM ``patch`` x ``patch`` patch and a
    spatial term at 512x512: tuned_config(CONFIG2.replace(patch_size=patch,
    spatial_h=8.0), 512*512, "fast"): strip_cache, bf16 store (K1's
    coordinate cross, 52 live lanes of 64 at 7 x 7), coarse Sinkhorn 1/16
    + one polish, sketch: (cfg, clean image, noisy f32 image, plan)."""
    cfg = gt.tuned_config(gt.CONFIG2.replace(patch_size=patch, spatial_h=8.0),
                          H * W, "fast")
    require(cfg.strip_cache and cfg.affinity_dtype == "bfloat16_store",
            "recipe A did not resolve to strip_cache with the bf16 store")
    img, noisy = noisy_image(gt, H, W)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_config1_fast(gt):
    """Config 1's own fast preset at 512x512, tuned_config(CONFIG1, 512*512,
    "fast"): strip_cache, bf16 store, gaussian + (row, col) / 8 features
    (K1's coordinate cross), coarse Sinkhorn 1/16 + one polish, sketch:
    (cfg, clean image, noisy f32 image, plan)."""
    cfg = gt.tuned_config(gt.CONFIG1, H * W, "fast")
    img, noisy = noisy_image(gt, H, W)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_8mp(gt, h=H8, w=W8, patch=5):
    """benchmarks/run.py's cfg4_8mp_compliant_turbo_p1 (row4 + row4p),
    rebuilt on the port, with an NLM ``patch`` x ``patch`` patch: (cfg,
    clean image, noisy f32 image, plan)."""
    cfg = gt.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=6, filter_name="identity",
        streaming=True, block_cols=65536, affinity_dtype="bfloat16",
        use_pallas=True, sinkhorn_coarse=64, gram_coarse=64,
        sinkhorn_polish=1, fused_finish=True, patch_size=patch)
    img, noisy = noisy_image(gt, h, w)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_8mp_p7(gt):
    """Config 4 at 7 x 7: cfg4_8mp_compliant_turbo_p1 with patch_size=7,
    the 64-lane layouts (bf16 aug tiles of 55 lanes padded to 64)."""
    return make_workload_8mp(gt, patch=7)


def make_workload_8mp_turbo(gt, patch=5):
    """benchmarks/run.py's cfg4_8mp_turbo_sc64_gc64 (row4 + row4x), rebuilt
    on the port, with an NLM ``patch``: (cfg, clean image, noisy f32 image,
    plan)."""
    cfg = gt.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=6, filter_name="identity",
        streaming=True, block_cols=65536, affinity_dtype="bfloat16",
        use_pallas=True, sinkhorn_coarse=64, gram_coarse=64,
        patch_size=patch)
    img, noisy = noisy_image(gt, H8, W8)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_cfg3(gt, patch=5):
    """benchmarks/run.py's cfg3_1024_rgb_sharpen (row3), rebuilt on the
    port, with an NLM ``patch`` x ``patch`` patch (config 3's 5; 7: the
    CLI's -patch 7, bf16 aug tiles of 55 lanes padded to 64): (cfg, clean
    image, noisy f32 image, plan)."""
    img = gt.make_test_image(H3, W3, channels=3)
    noisy = np.ascontiguousarray(
        np.clip(gt.add_gaussian_noise(img, 0.03, seed=3), 0, 1), np.float32)
    cfg = gt.tuned_config(gt.CONFIG3.replace(streaming=True,
                                             block_cols=131072,
                                             patch_size=patch),
                          H3 * W3, "fast")
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_8mp_matvec(gt, patch=5):
    """benchmarks/run.py's cfg4_8mp_quality_matvec (row4q: row4's config
    through denoise_tuned(0.1) and tuned_config "fast"), rebuilt on the
    port, with an NLM ``patch`` x ``patch`` patch (7: f32 tiles of 49 lanes
    padded to 64): (cfg, clean image, noisy f32 image, plan)."""
    base = gt.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=10, filter_name="identity",
        streaming=True, block_cols=131072, affinity_dtype="bfloat16",
        patch_size=patch)
    cfg = gt.tuned_config(gt.denoise_tuned(base, 0.1), H8 * W8, "fast")
    img, noisy = noisy_image(gt, H8, W8)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def grad_energy(a) -> float:
    return float((np.diff(a, axis=0) ** 2).sum()
                 + (np.diff(a, axis=1) ** 2).sum())


def matvec_cases(ctx, dev, names, rows):
    """K5/K6 at a path's shapes on its layouts, positive vectors from a
    seeded generator (scales and pixels, as the path feeds them)."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    aug = ctx.fa_aug is not None
    fa = ctx.fa_aug if aug else ctx.fa_pad
    pp, nk = fa.shape[0], ctx.f_t.shape[1]
    fd = ctx.f_t.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    v = 0.5 + torch.rand(nk, generator=gen, device=dev)
    t = torch.zeros(pp, device=dev)
    t[:ctx.p] = 0.5 + torch.rand(ctx.p, generator=gen, device=dev)
    e = pp * nk
    item = fa.element_size()
    feat_bytes = item * fd * (pp + nk)
    # bf16: the d2 product on the tensor cores and 8 f32 operations an
    # entry (as K8), no exp (a table entry); f32: the cross at the
    # reference's "highest" precision, six fp16 tensor-core passes of 2 fd
    # an entry (big, mid and lo parts of the features: 13.4 ms at 8 MP and
    # 32 lanes, 26.7 at 64; as an IEEE-f32 SIMT cross 36.9 and 73.8 ms), the
    # same 8 f32 operations and one exp an entry
    flops = (dict(bf16_flops=2 * e * fd, f32_flops=8 * e) if aug
             else dict(bf16_flops=6 * 2 * e * fd, f32_flops=8 * e, exps=e))
    b_ms = bound(feat_bytes + 4 * (nk + pp), **flops)  # f32 vector in, out
    mv, rmv = names
    cases = {mv: (k56.matvec_cuda, k56.matvec_plain, (fa, ctx.f_t, v, aug),
                  b_ms),
             rmv: (k56.rmatvec_cuda, k56.rmatvec_plain, (fa, ctx.f_t, t, aug),
                   b_ms)}
    # each output's lean, on the sample rows and the image's columns; the
    # f32 layout's also against its sums in f64, required too since K5's
    # tile sums join its running sums by a compensated add (a plain add
    # dropped the tiles far from a row's live entries, and 0.63 / 0.73 of
    # its rows lay below f64 at 32 / 64 lanes); the aug layout's against
    # the f64 sums of the same bf16 entries, required at every depth since
    # its w product sums on the FP32 pipe (by mma, whose accumulation
    # truncates, K6 sat below on 0.879 / 0.877 of config 3's columns at 32
    # / 64 lanes)
    signed = {mv: (0, ctx.p, True, True), rmv: (0, ctx.n, True, True)}
    if aug:
        signed = {
            mv: [signed[mv], (0, ctx.p, True, True,
                              lambda a, b, x, _: aug_f64_sums(a, b, "matvec",
                                                              x))],
            rmv: [signed[rmv], (0, ctx.n, True, True,
                                lambda a, b, x, _: aug_f64_sums(
                                    a, b, "rmatvec", x))]}
    else:
        signed = {
            mv: [signed[mv], (0, ctx.p, True, True,
                              lambda a, b, x, _: f64_sums(a, b, "matvec", x))],
            rmv: [signed[rmv], (0, ctx.n, True, True,
                                lambda a, b, x, _: f64_sums(a, b, "rmatvec",
                                                            x))]}
    return cases, rows, signed


def ext2_recompute_f64(fa, f_t, t2, bm, aug):
    """K8's function with its plain version's rounding points (the bf16
    tile entries, bf16 t2) and its sums in f64, kept in f64, over column
    chunks: the reference of K8's s lean line, (u, s)."""
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    t2r = t2.to(fa.dtype).double()
    u = torch.zeros(fa.shape[0], dtype=torch.float64, device=fa.device)
    s = torch.empty(f_t.shape[1], dtype=torch.float64, device=fa.device)
    for j in range(0, f_t.shape[1], 16384):
        sl = slice(j, j + 16384)
        kb = k79._tile_plain(fa, f_t[:, sl], aug).double()
        kbt = t2r @ kb
        s[sl] = bm[sl].double() / torch.sqrt(
            torch.clamp(kbt[0] * kbt[1], min=1e-30))
        u += kb @ s[sl]
    return u, s


def k9_parts(k79, args, n) -> dict:
    """K9's V error split in two (K8's u and s are split the same way):
    ``s_rel``, its s against the plain s (max over max |plain s|), with the
    share of differing columns where it lies above and the share whose
    bf16(s), the V pass's column scale, differs; ``v_pass_rel``, its V
    against the plain V formed from the kernel's own s (the V pass alone);
    ``s_part_rel``, that plain V against the plain V from the plain s (the
    s difference carried through V); ``v_rel``, its V against the plain V.
    All V errors over max |plain V|, on the first n columns. Of the column
    where V's error peaks: ``worst_v``, its max |plain V| over max |plain
    V|; ``worst_s_rel``, |s - plain s| / s; ``worst_edge``, the distance of
    the plain s from its nearest bf16 rounding boundary over s (a flip of
    bf16(s) needs the two s to straddle it)."""
    fa, f_t, t, s_pre, bm, gr, y, na, nb = args
    v_k, _, _, s_k = k79.finish_colstats_cuda(*args)
    v_p, _, _, s_p = k79.finish_colstats_plain(*args)
    v_ks = k79.colstats_v_plain(fa, f_t, gr, y, s_k, na, nb)[0]
    v_k, v_p, v_ks, s_k, s_p = v_k[:n], v_p[:n], v_ks[:n], s_k[:n], s_p[:n]
    vmax = float(v_p.abs().max())
    d = s_k - s_p
    cb_k, cb_p = s_k.to(torch.bfloat16), s_p.to(torch.bfloat16)
    j = int((v_k - v_p).abs().amax(dim=1).argmax())
    sj = float(s_p[j])
    ulp = 2.0 ** (np.floor(np.log2(sj)) - 7) if sj > 0 else 0.0
    edge = (abs((sj / ulp) % 1.0 - 0.5) * ulp / sj) if sj > 0 else 0.0
    out = dict(
        v_rel=float((v_k - v_p).abs().max()) / vmax,
        v_pass_rel=float((v_k - v_ks).abs().max()) / vmax,
        s_part_rel=float((v_ks - v_p).abs().max()) / vmax,
        s_rel=float(d.abs().max() / s_p.abs().max()),
        s_above=float((d[d != 0] > 0).float().mean()) if bool((d != 0).any())
        else 0.0,
        cb_flips=float((cb_k != cb_p).float().mean()),
        worst_v=float(v_p[j].abs().max()) / vmax,
        worst_s_rel=abs(float(s_k[j]) - sj) / sj if sj > 0 else 0.0,
        worst_edge=edge)
    del v_k, v_p, v_ks
    torch.cuda.empty_cache()
    return out


def colstats_v_cases(ctx, cfg, img_d, dev, rows, name="colstats_v"):
    """K10 (``name``) at the turbo path's shapes on its layouts: V's
    eigenvector block and the column scales from a seeded generator, the
    image as y; V's lean is required."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    p, n = ctx.p, ctx.n_pad
    pp, nk = ctx.fa_pad.shape[0], ctx.f_t.shape[1]
    mk = ms._m_kernel(cfg.num_eigvecs)
    gen = torch.Generator(device=dev).manual_seed(1)
    gr = torch.zeros((pp, mk), device=dev)
    gr[:p, :cfg.num_eigvecs] = (torch.rand(p, cfg.num_eigvecs, generator=gen,
                                           device=dev) - 0.5) * 0.02
    y = torch.zeros(nk, device=dev)
    y[:ctx.n] = img_d.reshape(-1)
    cols = torch.zeros(nk, device=dev)
    cols[:n] = (0.5 + torch.rand(n, generator=gen, device=dev)) * ctx.b_mask
    na, nb = ms._sq_norms_pad(ctx)
    fd = ctx.f_t.shape[0]
    e = pp * nk
    cases = {
        name: (k79.colstats_v_cuda, k79.colstats_v_plain,
                       (ctx.fa_pad, ctx.f_t, gr, y, cols, na, nb),
                       bound(2 * fd * (pp + nk) + 4 * nk * (3 + mk)
                             + 4 * pp * (mk + 1), 2 * e * (fd + mk), 6 * e,
                             e),
                       colstats_scales(y)),
    }
    return cases, rows, {name: (0, n, False, True)}


def strip_library(dtype=torch.bfloat16) -> dict:
    """K1-K4's yardsticks on a strip of ``dtype``: each kernel's function as
    a composition of cuBLAS products with f32 output and elementwise
    passes, timed beside the kernel; the port never calls them. On a bf16
    strip the products take bf16 operands (torch.mm out_dtype,
    aten::mm.dtype), so t2, t, ta, s and ws are rounded to bf16 first; on
    an f32 strip they are f32 products at "highest" (the port pins TF32
    off) with no rounding point, named ``*_f32`` as strip_cases names
    them."""
    bf, f32 = torch.bfloat16, torch.float32
    sfx = "_f32" if dtype == f32 else ""

    def r(x):
        """An operand as the strip's type: bf16-rounded on a bf16 strip."""
        return f"bf16({x})" if dtype == bf else x

    def affinity(a, b, dtype, store, coords=False):
        # the f32 product at "highest" (the port pins TF32 off), then the
        # norms, the clamp, the exp and the store's cast
        a, b = a.to(dtype).to(f32), b.to(dtype).to(f32)
        d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
              - 2.0 * torch.mm(a, b.T))
        return torch.exp(-d2.clamp_(min=0.0)).to(store or f32)

    def mm(a, b):
        return (torch.mm(a, b) if a.dtype == f32
                else torch.mm(a, b, out_dtype=f32))

    def sandwich(strip, ta, s2):
        w = mm(strip.T, ta.to(strip.dtype))
        return mm(strip, (w * s2[:, None]).to(strip.dtype))

    def spost(strip, ta, t, s_pre, bm):
        ks = mm(t.to(strip.dtype)[None], strip)[0]
        sp = torch.sqrt(s_pre / torch.clamp(ks, min=1e-30)) * bm
        return sandwich(strip, ta, sp * sp), sp

    def ext2(strip, t2, bm):
        kbt = mm(t2.to(strip.dtype), strip)
        s = bm / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
        return mm(strip, s.to(strip.dtype)[:, None])[:, 0], s

    what = "a cuBLAS composition, not one call: "
    cross = what + "torch.mm(a, b^T) in f32 at \"highest\" (no TF32), the norms, "
    sweeps = (what + ("the products on bf16 operands with f32 output: "
                      if dtype == bf else "f32 products at \"highest\": "))
    return {
        "affinity_strip": (affinity, cross + "the clamp, exp and the bf16 "
                           "cast"),
        "affinity_strip_f32": (affinity, cross + "the clamp and exp"),
        **{f"affinity_strip_coord{w}": (affinity, cross + "the clamp, exp "
                                        "and the bf16 cast")
           for w in ("", "_d64", "_d96", "_d128")},
        **{f"affinity_strip_coord_f32{w}": (affinity, cross + "the clamp "
                                            "and exp") for w in ("_d96", "_d128")},
        **{f"affinity_strip{w}": (affinity, cross + "the clamp, exp and the "
                                  "bf16 cast") for w in ("_d64", "_d96", "_d128")},
        **{f"affinity_strip_f32{w}": (affinity, cross + "the clamp and exp")
           for w in ("_d64", "_d96", "_d128")},
        "strip_ext2" + sfx: (ext2, sweeps + f"mm({r('t2')}, K), the scale, "
                             f"then mm(K, {r('s')})" + (
                                 " (cuBLAS has no bf16 x f32 product)"
                                 if dtype == bf else "")),
        "strip_sandwich_spost" + sfx: (spost, sweeps + f"mm({r('t')}, K) for "
                                       f"ks, s_post, mm(K^T, {r('ta')}), the "
                                       f"s2 scale, mm(K, {r('ws')})"),
        "strip_sandwich" + sfx: (sandwich, sweeps + f"mm(K^T, {r('ta')}), the "
                                 f"s2 scale, mm(K, {r('ws')})"),
    }


def kb_library(fa, f_t, cols, aug):
    """K7's yardstick: its function as one bf16-in / f32-out cuBLAS product
    (torch.mm out_dtype) and elementwise passes with the kernel's rounding
    points: bf16(max(d2, 0)), the exp, the entry's bf16 rounding, the scale
    by bf16(cols), the bf16 cast. Timed beside the kernel; the port never
    calls it."""
    bf, f32 = torch.bfloat16, torch.float32
    d2 = torch.mm(fa, f_t, out_dtype=f32).clamp_(min=0.0)
    kb = torch.exp(-d2.to(bf).to(f32)).to(bf).to(f32)
    return (kb * cols.to(bf).to(f32)[None, :]).to(bf)


def _as_strip(x, strip):
    """x in f64 with its plain version's rounding point: rounded to bf16
    before the product on a bf16 strip, as given on an f32 one (the
    "highest" class)."""
    return (x.to(strip.dtype) if strip.dtype == torch.bfloat16 else x).double()


def ext2_f64(strip, t2, bm):
    """K2's function with its plain version's rounding points (bf16 t2 on a
    bf16 strip) and its sums in f64, kept in f64: the reference of K2's lean
    lines, (u, s). K2's s is one f32 division of f32 sums, so it often
    equals the f64 s rounded to f32; the tie would count as not below."""
    kb = strip.double()
    kbt = _as_strip(t2, strip) @ kb
    s = bm.double() / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    return kb @ s, s


def sandwich_f64(strip, ta, s2):
    """K4's function with its plain version's rounding points (on a bf16
    strip: bf16 ta, ws rounded to bf16; on an f32 strip none) and its sums
    in f64: the reference of K3/K4's lean line. The f32 sums of the plain
    version lean low themselves on some strips (0.92 of u below this
    reference on a random one). Rounded to f32 on a bf16 strip; kept in
    f64 on an f32 one, whose kernel sums tie the f32 rounding of this
    reference on many entries, and a tie counts as not below."""
    kb = strip.double()
    ws = (kb.T @ _as_strip(ta, strip)) * s2.double()[:, None]
    if strip.dtype == torch.bfloat16:
        return (kb @ ws.to(torch.bfloat16).double()).float()
    return kb @ ws


def spost_f64(strip, ta, t, s_pre, bm):
    """K3's function as ``sandwich_f64``: (u, s_post)."""
    ks = _as_strip(t, strip) @ strip.double()
    sp = torch.sqrt(s_pre.double() / torch.clamp(ks, min=1e-30)) * bm.double()
    return sandwich_f64(strip, ta, sp * sp), sp.float()


def ffma_bound(strip, kp2=256, spost=False):
    """The f32 K3/K4's bound as the FFMA tile they replaced counted it: the
    strip and the operands read once, 4 P N kp f32 flop (K3: and its ks, 2
    P N) at the f32 FFMA peak. (bound_ms, bound_by)."""
    pp, n = strip.shape
    e = pp * n
    return bound(4 * e + 4 * pp * kp2 * 2 + 4 * n * 3 + 4 * pp * 3,
                 f32_flops=4 * e * kp2 + (2 * e if spost else 0))


def sandwich_f64_check(label, kern, plain, args, p):
    """K3's (5 arguments) or K4's u on an f32 strip, on the p sample rows,
    against its sums in f64 (sums_f64_check over the f64 sum of the
    magnitudes of u's terms, K ((K^T |ta|) s2): u's terms cancel), with the
    share of (u - u64) sign(u64) below zero in SIGNED_BAND; also held to
    the plain version column by column (TOL, over each column's max
    |plain|) and launched twice bit for bit. Returns the record."""
    strip, ta = args[0], args[1]
    kb = strip.double()
    if len(args) == 5:
        t, s_pre, bm = args[2:]
        s2 = (s_pre.double() / torch.clamp(t.double() @ kb, min=1e-30)
              * bm.double())
    else:
        s2 = args[2].double()
    u64 = (kb @ ((kb.T @ ta.double()) * s2[:, None]))[:p]
    scale = (kb @ ((kb.T @ ta.double().abs()) * s2[:, None]))[:p]
    del kb
    torch.cuda.empty_cache()
    first = lambda x: x[0] if isinstance(x, tuple) else x  # noqa: E731
    got, ref = first(kern(*args))[:p], first(plain(*args))[:p]
    again = first(kern(*args))[:p]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    require(torch.equal(got, again), f"{label}: two launches differ")
    col = float(((got - ref).abs().amax(0)
                 / ref.abs().amax(0).clamp_min(1e-30)).max())
    rec = sums_f64_check(label + " u", got, ref, u64, scale)
    st = signed_stats(got, u64, False)
    phase("sums", f"{label}: share below f64 {st['share_below']:.4f} "
          f"(required in {SIGNED_BAND}); against plain, column by column "
          f"{col:.3e} (tol 1e-4)")
    require(col <= 1e-4, f"{label} disagrees with its plain version")
    require(SIGNED_BAND[0] < st["share_below"] < SIGNED_BAND[1],
            f"{label}: biased to one side of its f64 sums")
    return dict(rec, share_below_f64=st["share_below"], column_rel_err=col)


def sandwich_f64_checks(cases, p, dev):
    """The f32 K3 and K4 (their run_cases inputs, and the same with ta's
    columns scaled by 2^e, e drawn from [-16, 16], and its rows by A-scales
    2^x, x drawn from [-3, 3]: the octaves of the path's ta and ws) against
    their f64 sums (sandwich_f64_check). Returns the record."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name in ("strip_sandwich_spost_f32", "strip_sandwich_f32"):
        kern, plain, args = cases[name][:3]
        out[name] = sandwich_f64_check(name, kern, plain, args, p)
        ta = args[1]
        cols = torch.randint(-16, 17, (ta.shape[1],), generator=gen,
                             device=dev).float()
        rows = 6.0 * torch.rand(ta.shape[0], generator=gen, device=dev) - 3.0
        scaled = ta * torch.exp2(rows)[:, None] * torch.exp2(cols)[None, :]
        out[name + "_scaled"] = sandwich_f64_check(
            name + " (ta's columns 2^+-16, rows 2^+-3)", kern, plain,
            (args[0], scaled, *args[2:]), p)
        del scaled
    return out


def path_sandwich_operands(gt, cfg, noisy, plan, dev):
    """One filter_image call with K3's and K4's arguments recorded (the
    strip model's kernel table wrapped for the call; its launches are
    outside every counted run): {"K3": args, "K4": args}."""
    from graphlap_tpu_torch.models import streaming as ms

    seen = {}
    kernels = ms._kernels

    def recording(plain):
        k1_fn, k2_fn, k3_fn, k4_fn = kernels(plain)

        def k3(*args):
            seen["K3"] = args
            return k3_fn(*args)

        def k4(*args):
            seen["K4"] = args
            return k4_fn(*args)
        return k1_fn, k2_fn, k3, k4
    ms._kernels = recording
    try:
        gt.filter_image(noisy, cfg, plan=plan, device=dev)
    finally:
        ms._kernels = kernels
    return seen


def octaves(x) -> dict:
    """The range of a tensor's nonzero magnitudes: min, max and their span
    in octaves (log2 max / min)."""
    a = x.abs()
    a = a[a > 0]
    lo, hi = float(a.min()), float(a.max())
    return dict(min=lo, max=hi, octaves=math.log2(hi / lo))


def path_sandwich_ranges(seen, p) -> dict:
    """The real path's K3/K4 operands: ta's column maxima and row maxima
    (the sketch columns' and the A-scaled sample rows' magnitudes) for K3
    (t1) and K4 (tq), and K4's s2 = s_post^2 over the live columns."""
    out = {}
    for key, args in seen.items():
        ta = args[1][:p]
        out[key] = dict(ta_columns=octaves(ta.abs().amax(0)),
                        ta_rows=octaves(ta.abs().amax(1)),
                        ta=octaves(ta))
    out["K4"]["s2"] = octaves(seen["K4"][2])
    return out


def strip_cases(ctx, cfg, dev):
    """K1-K4 at a strip_cache path's shapes on its strip context, operands
    from a seeded generator: (cases, signed, library) for run_cases. K1 in
    the path's layout on its feature rows, the padding rows poisoned as
    ``_strip_ctx`` poisons them: ``affinity_strip`` (the bf16 store),
    ``affinity_strip_f32`` (the f32 store) or ``affinity_strip_coord`` (the
    IEEE f32 cross on coordinate features, the bf16 store). K2's lean (u on
    the sample rows, s on the columns) and K3/K4's (u = K ws on the sample
    rows, both signs) are required, against ``ext2_f64``, ``spost_f64`` /
    ``sandwich_f64``. On an f32 strip K2-K4 are named ``*_f32`` and their
    sandwich products counted as six bf16 tensor passes (the kernel's three
    parts an operand, ``F32_SANDWICH_PASSES``; ``ffma_bound`` gives the f32
    FFMA bound of the design it replaced); each beside ``strip_library``'s
    composition for the strip's dtype."""
    from graphlap_tpu_torch.ops import cuda_strip as k24

    strip, p = ctx.strip_pad, ctx.p
    pp, n = strip.shape
    f32 = strip.dtype == torch.float32
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, p)
    kp = -(-k // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    t2 = torch.zeros((2, pp), device=dev)
    t2[:, :p] = 0.5 + rand(2, p)
    ta = torch.zeros((pp, kp), device=dev)
    ta[:p] = rand(p, kp) - 0.5
    t1 = torch.zeros(pp, device=dev)
    t1[:p] = 0.5 + rand(p)
    s_pre = (0.5 + rand(n)) * ctx.b_mask
    s2 = (0.5 + rand(n)) * ctx.b_mask
    e, kp2, item = pp * n, 256, strip.element_size()
    vec = 4 * n * 3 + 4 * pp * 3
    sfx = "_f32" if f32 else ""

    def products(beside=0.0):
        """The sandwich's two (P x N) x (N x kp) products on the tensor
        cores: bf16, or on an f32 strip F32_SANDWICH_PASSES bf16 passes;
        ``beside``: f32 work next to them."""
        passes = F32_SANDWICH_PASSES if f32 else 1
        return dict(bf16_flops=passes * 4 * e * kp2, f32_flops=beside)

    cases = dict([k1_case(ctx, f32, dev)])
    cases.update({
        "strip_ext2" + sfx: (k24.strip_ext2_cuda, k24.strip_ext2_plain,
                             (strip, t2, ctx.b_mask),
                             bound(item * e + vec, 0, 6 * e)),
        "strip_sandwich_spost" + sfx: (k24.strip_sandwich_spost_cuda,
                                       k24.strip_sandwich_spost_plain,
                                       (strip, ta, t1, s_pre, ctx.b_mask),
                                       bound(item * e + 4 * pp * kp2 * 2
                                             + vec, **products(2 * e))),
        "strip_sandwich" + sfx: (k24.strip_sandwich_cuda,
                                 k24.strip_sandwich_plain, (strip, ta, s2),
                                 bound(item * e + 4 * pp * kp2 * 2 + vec,
                                       **products())),
    })
    signed = {"strip_ext2" + sfx: [(0, p, False, True, ext2_f64),
                                   (1, n, True, True, ext2_f64)],
              "strip_sandwich_spost" + sfx: (0, p, False, True, spost_f64),
              "strip_sandwich" + sfx: (0, p, False, True, sandwich_f64)}
    return cases, signed, strip_library(strip.dtype)


def k1_case(ctx, f32, dev):
    """(name, case) of K1 on a strip_cache path's feature rows, the padding
    rows poisoned as ``_strip_ctx`` poisons them, into the strip's shape:
    ``affinity_strip`` (the bf16 store), ``affinity_strip_f32`` (``f32``:
    the f32 store) or ``affinity_strip_coord`` (the IEEE f32 cross on
    coordinate features, the bf16 store), with ``_d64`` past 32 feature
    lanes (the 64-lane instantiation; ``_d96``, ``_d128`` past 64). Its
    bound: the store's bytes and the features read once; the operations:
    one exp an entry and the cross, at the reference's "highest" precision
    as three fp16 tensor passes over the kernel's padded lanes (six for the
    f32 store past 64 lanes, its split in three parts) and ~8 f32
    operations an entry (as the f32 K5/K6 count it, matvec_cases), or on
    coordinate features the IEEE f32 FFMA chain over the live lanes."""
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    pp, n = ctx.strip_pad.shape
    p, d = ctx.feats_a.shape
    feats_a = torch.full((pp, d), 1e3, device=dev)
    feats_a[:p] = ctx.feats_a
    e, item = pp * n, 4 if f32 else 2
    k1_bytes = item * e + 4 * d * (pp + n)
    lanes = -(-d // 32) * 32
    name = ("affinity_strip_coord" if ctx.coords else
            "affinity_strip_f32" if f32 else "affinity_strip")
    name += lanes_sfx(lanes)
    passes = 6 if f32 and lanes > 64 else 3
    k1_bound = (bound(k1_bytes, 0, 2 * ctx.live * e, e) if ctx.coords else
                bound(k1_bytes, passes * 2 * e * lanes, 8 * e, e))
    return name, (k1.affinity_strip_cuda, k1.affinity_strip_plain,
                  (feats_a, ctx.feats_pad, ctx.dtype,
                   None if f32 else torch.bfloat16, ctx.coords), k1_bound)


def config2(gt, dev, rows, launches, info):
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    cases, signed, library = strip_cases(ctx, cfg, dev)
    phase("config2", f"workload and strip context at {H}x{W} (p={ctx.p}, "
          f"p_pad={ctx.strip_pad.shape[0]}, N={ctx.strip_pad.shape[1]})", t0)
    run_cases(cases, rows, signed, library)
    del ctx, cases
    torch.cuda.empty_cache()

    counters = {"affinity_strip": k1.affinity_strip_cuda,
                "strip_ext2": k24.strip_ext2_cuda,
                "strip_sandwich_spost": k24.strip_sandwich_spost_cuda,
                "strip_sandwich": k24.strip_sandwich_cuda}
    _, rec = strip_path(gt, "config 2", cfg, img, noisy, plan, dev, counters,
                        (0.05, 2e-2))
    require(rec["psnr_out"] > rec["psnr_in"] + 5.0, "denoise gain under 5 dB")
    launches.update({k: round(c * RUNS)
                     for k, c in rec["launches_per_call"].items()})
    rec.update(small_strip(gt, cfg, dev, (0.05, 2e-2), "config 2"))
    info["config2"] = rec


def config2_patch(gt, dev, rows, launches, info, patch=7):
    """Config 2 at an NLM ``patch`` x ``patch`` patch (7, 9 or 11:
    make_workload(gt, patch), the CLI's -patch; 49, 81 or 121 lanes): K1's
    64-, 96- or 128-lane split cross, both stores, on the path's own
    features into its strip's shape (K2-K4 take the strip as at 5 x 5: no
    feature axis); the path end to end with its bf16 strip, and with its
    f32 strip kept (make_workload_f32 at the patch, the f32 store's path).
    The denoise gain required: 5 dB at 7 x 7; 3 dB at 9 x 9 and 11 x 11,
    where the reference gains 5.07 and 4.72 dB on the recipe at 256^2
    (scripts/reference_quality.py --recipes 2p9 2p11)."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    t0 = time.perf_counter()
    d = patch * patch
    sfx, gain = lanes_sfx(-(-d // 32) * 32), 5.0 if patch == 7 else 3.0
    tag = f"config 2 at {patch}x{patch}"
    cfg, img, noisy, plan = make_workload(gt, patch)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    pp, n = ctx.strip_pad.shape
    require(ctx.feats_a.shape[1] == d and ctx.strip_pad.dtype
            == torch.bfloat16, f"{tag} did not reach {d} lanes and the bf16 "
            f"store")
    phase(f"config2-p{patch}", f"workload and strip at {H}x{W} (p={ctx.p}, "
          f"p_pad={pp}, N={n}, {ctx.feats_a.shape[1]} feature lanes)", t0)
    cases = dict(k1_case(ctx, f32, dev) for f32 in (False, True))
    run_cases(cases, rows, library=strip_library())
    del ctx, cases
    torch.cuda.empty_cache()

    stages = {"strip_ext2": k24.strip_ext2_cuda,
              "strip_sandwich_spost": k24.strip_sandwich_spost_cuda,
              "strip_sandwich": k24.strip_sandwich_cuda}
    _, rec = strip_path(gt, tag, cfg, img, noisy, plan, dev,
                        {"affinity_strip" + sfx: k1.affinity_strip_cuda,
                         **stages}, (0.05, 2e-2))
    require(rec["psnr_out"] > rec["psnr_in"] + gain,
            f"{tag}: denoise gain under {gain} dB")
    launches["affinity_strip" + sfx] = round(
        rec["launches_per_call"]["affinity_strip" + sfx] * RUNS)
    torch.cuda.empty_cache()
    rec.update(small_strip(gt, cfg, dev, (0.05, 2e-2), tag))

    # the f32 store's path: config 2's f32 strip kept, at the patch
    cfg, img, noisy, plan = make_workload_f32(gt, patch=patch)
    _, rec_f32 = strip_path(
        gt, f"config 2 f32 at {patch}x{patch}", cfg, img, noisy, plan, dev,
        {"affinity_strip_f32" + sfx: k1.affinity_strip_cuda,
         **{k + "_f32": fn for k, fn in stages.items()}}, (0.02, 2e-3))
    require(rec_f32["psnr_out"] > rec_f32["psnr_in"] + gain,
            f"config 2 f32 at {patch}x{patch}: denoise gain under {gain} dB")
    launches["affinity_strip_f32" + sfx] = round(
        rec_f32["launches_per_call"]["affinity_strip_f32" + sfx] * RUNS)
    rec["f32_strip"] = rec_f32
    info[f"config2_p{patch}"] = rec


def small_strip(gt, cfg, dev, bars, tag):
    """The strip_cache recipe at 96x96 (block_cols and the coarse factor
    cut to fit): the card's kernels against the plain versions on the CPU,
    the same sketch matrix, within ``bars`` (dB, max |diff|)."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    t0 = time.perf_counter()
    small = cfg.replace(block_cols=96 * 96, sinkhorn_coarse=4)
    im_s, nz_s = noisy_image(gt, 96, 96)
    pl_s = gt.make_plan(nz_s, small)
    k_s = min(small.num_eigvecs + small.sketch_oversample, pl_s.p)
    om = ms.sketch_omega(pl_s.p, k_s, "cpu")
    idx_s = pl_s.idx_a.astype(np.int64)
    z_cpu, _ = _filter_channel(torch.as_tensor(nz_s), torch.as_tensor(idx_s),
                               small, om)
    z_gpu, _ = _filter_channel(torch.as_tensor(nz_s, device=dev),
                               torch.as_tensor(idx_s, device=dev), small,
                               om.to(dev))
    z_cpu, z_gpu = z_cpu.numpy(), z_gpu.cpu().numpy()
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"{tag} at 96x96: card kernels vs CPU plain: {s_db:.5f} "
          f"dB, max |diff| {s_max:.3e} (bar {bars[0]} dB, {bars[1]:.0e}); "
          f"PSNR {gt.psnr(im_s, nz_s):.3f} -> {gt.psnr(im_s, z_gpu):.3f} dB",
          t0)
    require(np.isfinite(z_gpu).all() and s_db <= bars[0]
            and s_max <= bars[1], f"{tag}: 96x96 card run != CPU plain run")
    return dict(small_db=s_db, small_max=s_max)


def strip_path(gt, tag, cfg, img, noisy, plan, dev, counters, bars):
    """A strip_cache recipe at full size: ``drive`` with each kernel of
    ``counters`` launched once a call, and the kernel path against the plain
    path on the card within ``bars``. Returns (result, the phase's
    record)."""
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    t0 = time.perf_counter()
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters, tag)
    per_call = {k: c / RUNS for k, c in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e", f"{tag}: walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}); launches per call {per_call}", t0)
    require(res.image.shape == noisy.shape and np.isfinite(res.image).all(),
            f"{tag}: output is not a finite image of the input shape")
    require(all(c == 1 for c in per_call.values()),
            f"{tag}: not one launch a call of each of {list(counters)}")
    t0 = time.perf_counter()
    z_plain, vals_plain = _filter_channel(
        torch.as_tensor(noisy, device=dev),
        torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg,
        plain=True)
    z_plain, vals_plain = z_plain.cpu().numpy(), vals_plain.cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    # the filter's eigenvalues too: they hold the two paths together where
    # the image is clipped flat (a recipe whose output degenerates)
    require(res.eigvals.shape == vals_plain.shape
            and np.isfinite(res.eigvals).all(), f"{tag}: eigenvalues")
    d_eig = float(np.abs(res.eigvals - vals_plain).max())
    phase("e2e", f"{tag}: kernel vs plain path on the card: {d_db:.5f} dB, "
          f"max |diff| {d_max:.3e}, eigenvalues max |diff| {d_eig:.3e} (bar "
          f"{bars[0]} dB, {bars[1]:.0e}); top eigenvalues "
          f"{np.sort(res.eigvals)[::-1][:3].tolist()}", t0)
    require(d_db <= bars[0] and d_max <= bars[1] and d_eig <= bars[1],
            f"{tag}: kernel path != plain path")
    return res, dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                     psnr_out=psnr_out, launches_per_call=per_call,
                     plain_path_db=d_db, plain_path_max=d_max,
                     plain_path_eig_max=d_eig)


def config2_f32(gt, dev, rows, launches, info):
    """Config 2 with its f32 strip (make_workload_f32): K1's f32 store, the
    f32 K2-K4."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    f32_bars = (0.02, 2e-3)
    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_f32(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    require(ctx.strip_pad.dtype == torch.float32,
            "config 2 f32 did not keep an f32 strip")
    cases, signed, library = strip_cases(ctx, cfg, dev)
    phase("config2-f32", f"workload and f32 strip at {H}x{W} (p={ctx.p}, "
          f"p_pad={ctx.strip_pad.shape[0]}, N={ctx.strip_pad.shape[1]}, "
          f"{ctx.strip_pad.numel() * 4 / 1e9:.3f} GB)", t0)
    # K1's f32 store at this strip's shape, with its poisoned rows: its
    # kernels-line row is the dense phase's (K_AB), so this one is kept in
    # the phase's record
    k1_case = {"affinity_strip_f32": cases.pop("affinity_strip_f32")}
    run_cases(cases, rows, signed, library)
    for name, spost in (("strip_sandwich_spost_f32", True),
                        ("strip_sandwich_f32", False)):
        b_ms, _ = ffma_bound(ctx.strip_pad, spost=spost)
        rows[name]["ffma_bound_ms"] = b_ms
        phase("kernel", f"{name}: the f32 FFMA bound of the same products "
              f"{b_ms:.3f} ms (the bound above counts "
              f"{F32_SANDWICH_PASSES} bf16 tensor passes)")
    f64_sums = sandwich_f64_checks(cases, ctx.p, dev)
    at_path = {}
    run_cases(k1_case, at_path, library=library)
    del ctx, cases, k1_case
    torch.cuda.empty_cache()

    counters = {"affinity_strip_f32": k1.affinity_strip_cuda,
                "strip_ext2_f32": k24.strip_ext2_cuda,
                "strip_sandwich_spost_f32": k24.strip_sandwich_spost_cuda,
                "strip_sandwich_f32": k24.strip_sandwich_cuda}
    res, rec = strip_path(gt, "config 2 f32", cfg, img, noisy, plan, dev,
                          counters, f32_bars)
    require(rec["psnr_out"] > rec["psnr_in"] + 5.0,
            "config 2 f32: denoise gain under 5 dB")
    for name in ("strip_ext2_f32", "strip_sandwich_spost_f32",
                 "strip_sandwich_f32"):
        launches[name] = round(rec["launches_per_call"][name] * RUNS)
    del res
    torch.cuda.empty_cache()
    # the real path's K3/K4 operands: their octaves, and the kernels held to
    # their f64 sums on them
    t0 = time.perf_counter()
    seen = path_sandwich_operands(gt, cfg, noisy, plan, dev)
    p_live = plan.p
    rec["sandwich_ranges"] = path_sandwich_ranges(seen, p_live)
    phase("config2-f32", f"the path's K3/K4 operands: {rec['sandwich_ranges']}",
          t0)
    for key, name in (("K3", "strip_sandwich_spost_f32"),
                      ("K4", "strip_sandwich_f32")):
        kern = {"K3": k24.strip_sandwich_spost_cuda,
                "K4": k24.strip_sandwich_cuda}[key]
        plain = {"K3": k24.strip_sandwich_spost_plain,
                 "K4": k24.strip_sandwich_plain}[key]
        f64_sums[name + "_path"] = sandwich_f64_check(
            f"{name} on the path's operands", kern, plain, seen[key], p_live)
    rec["sandwich_f64"] = f64_sums
    del seen
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["staged"] = staged_one(
        gt, "config 2 f32", cfg, img, noisy, plan, dev,
        {"affinity_strip_f32": k1.affinity_strip_cuda}, bars=f32_bars)
    phase("staged", "config 2 f32 done", t0)
    torch.cuda.empty_cache()
    rec.update(small_strip(gt, cfg, dev, f32_bars, "config 2 f32"))
    rec["k1_at_path"] = at_path["affinity_strip_f32"]
    info["config2_f32"] = rec


def config1_fast(gt, dev, rows, launches, info, patch=None):
    """Config 1's fast preset (make_workload_config1_fast), or with
    ``patch`` 7, 9 or 11 recipe A, config 2 with an NLM patch and a spatial
    term (make_workload_cfg2_bilateral: 52, 84 or 124 live lanes of 64, 96
    or 128, K1's row named ``affinity_strip_coord`` and lanes_sfx): K1's
    coordinate cross with the bf16 store on the strip_cache strip, then the
    bf16 K2-K4 (their rows at the path's strip kept in the record, not at 9
    x 9 and 11 x 11, where the strip has config 2's shape). Past 7 x 7
    (whose row phase 10c's slabs hold to f64) K1's cross is held to f64 on
    512 sample rows by every pixel (k1_coord_slab), and at 11 x 11
    filter_image_staged to filter_image. Neither recipe denoises in the
    reference (ROADMAP Queue 3, known defects; recipe A at 256^2,
    scripts/reference_quality.py): the PSNR is printed, no gain required;
    the kernel path is held to the plain path on the image and the
    filter's eigenvalues, and at 96x96 to the CPU."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_strip as k24

    bf16_bars = (0.05, 2e-2)
    tag = ("config 1 fast" if patch is None
           else f"config 2 bilateral at {patch}x{patch}")
    k1_name = "affinity_strip_coord" + (
        "" if patch is None else lanes_sfx(PATCH_LANES[patch]))
    t0 = time.perf_counter()
    cfg, img, noisy, plan = (make_workload_config1_fast(gt) if patch is None
                             else make_workload_cfg2_bilateral(gt, patch))
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    require(ctx.coords and ctx.strip_pad.dtype == torch.bfloat16,
            f"{tag} did not reach the coordinate cross, bf16 store")
    require(patch is None or (ctx.live == NLM_COORD_LIVE[patch]
                              and ctx.feats_a.shape[1] == patch * patch + 2),
            f"{tag} did not reach {NLM_COORD_LIVE.get(patch)} live lanes")
    pp, n = ctx.strip_pad.shape
    phase("config1-fast" if patch is None else f"config2-bilateral-p{patch}",
          f"workload and strip at {H}x{W} (p={ctx.p}, "
          f"p_pad={pp}, N={n}, {ctx.feats_a.shape[1]} feature lanes, "
          f"{ctx.live} live)", t0)
    cases, signed, library = strip_cases(ctx, cfg, dev)
    # K1's coordinate cross has its kernels-line row here; the bf16 K2-K4
    # at this strip's shape (another ext2 plan: 336 rows a block) are held
    # to the same checks as config 2's, their rows kept in the phase's
    # record
    k1_case = {k1_name: cases.pop(k1_name)}
    run_cases(k1_case, rows, library=library)
    at_path = {}
    if patch in (None, 7):
        run_cases(cases, at_path, signed, library)
    else:
        rows[k1_name]["f64"] = k1_coord_slab(
            ctx.feats_a[:ctx.p][torch.linspace(0, ctx.p - 1, 512,
                                               device=dev).long()],
            ctx.feats_pad[:ctx.n], f"{k1_name} (512 sample rows)")
    del ctx, cases, k1_case, img_d, idx_d
    torch.cuda.empty_cache()

    counters = {k1_name: k1.affinity_strip_cuda,
                "strip_ext2": k24.strip_ext2_cuda,
                "strip_sandwich_spost": k24.strip_sandwich_spost_cuda,
                "strip_sandwich": k24.strip_sandwich_cuda}
    _, rec = strip_path(gt, tag, cfg, img, noisy, plan, dev,
                        counters, bf16_bars)
    gain = rec["psnr_out"] - rec["psnr_in"]
    phase("e2e", f"{tag}: denoise gain {gain:.3f} dB (not required: "
          f"the recipe degenerates in the reference too)")
    launches[k1_name] = round(rec["launches_per_call"][k1_name] * RUNS)
    torch.cuda.empty_cache()
    if patch == 11:
        t0 = time.perf_counter()
        rec["staged"] = staged_one(gt, tag, cfg, img, noisy, plan, dev,
                                   {k1_name: k1.affinity_strip_cuda})
        phase("staged", f"{tag} done", t0)
        torch.cuda.empty_cache()
    rec.update(small_strip(gt, cfg, dev, bf16_bars, tag))
    rec["k2_k4_at_path"] = at_path
    info["config1_fast" if patch is None
         else f"config2_bilateral_p{patch}"] = rec


def fused_inputs(cfg, plan, img_d, dev):
    """The fused finish's kernels' arguments at a recompute path's shapes,
    on its own layouts (``_strip_ctx``), the vectors from a seeded
    generator: K7's (fa_aug, gram columns of f_t, cols, True), K8's (fa_aug,
    f_t, t2, bm, True), K9's (fa_pad, f_t, t, s_pre, bm, gr, y, na, nb),
    with the context and its sizes."""
    from types import SimpleNamespace

    from graphlap_tpu_torch.models import streaming as ms

    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    p, n = ctx.p, ctx.n_pad
    pp, nk = ctx.fa_pad.shape[0], ctx.f_t.shape[1]
    mk = ms._m_kernel(cfg.num_eigvecs)
    jidx = torch.as_tensor(ms.gram_sample_idx(n, cfg.gram_coarse,
                                              cfg.gram_jitter_seed),
                           dtype=torch.int64, device=dev)
    ft_g = ctx.f_t[:, jidx]
    sg = ft_g.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    bm = torch.zeros(nk, device=dev)
    bm[:n] = ctx.b_mask
    t2 = torch.zeros((2, pp), device=dev)
    t2[:, :p] = 0.5 + rand(2, p)
    tv = torch.zeros(pp, device=dev)
    tv[:p] = 0.5 + rand(p)
    gr = torch.zeros((pp, mk), device=dev)
    gr[:p, :cfg.num_eigvecs] = (rand(p, cfg.num_eigvecs) - 0.5) * 0.02
    y = torch.zeros(nk, device=dev)
    y[:ctx.n] = img_d.reshape(-1)
    na = torch.zeros(pp, device=dev)
    na[:p] = torch.sum(ctx.feats_a * ctx.feats_a, dim=1)
    nb = torch.zeros(nk, device=dev)
    nb[:n] = torch.sum(ctx.feats_pad * ctx.feats_pad, dim=1)
    s_pre = (0.5 + rand(nk)) * bm
    return SimpleNamespace(
        ctx=ctx, p=p, n=n, pp=pp, nk=nk, mk=mk, sg=sg,
        k7=(ctx.fa_aug, ft_g, rand(sg), True),
        k8=(ctx.fa_aug, ctx.f_t, t2, bm, True),
        k9=(ctx.fa_pad, ctx.f_t, tv, s_pre, bm, gr, y, na, nb))


def config4(gt, dev, rows, launches, info, patch=5):
    """Config 4's fused finish at 8 MP (make_workload_8mp) with an NLM
    ``patch`` x ``patch`` patch: K7-K9 at the path's shapes, the path end
    to end, and the recipe at 96x96 against the CPU. At 7, 9 and 11 (64-,
    96- and 128-lane layouts) the kernels' rows are named ``*_d64``,
    ``*_d96``, ``*_d128``. The gain required, 1 dB, holds at every patch:
    at 9 x 9 and 11 x 11 the reference gains 2.02 and 1.80 dB on the
    recipe at 256 x 512 (scripts/reference_quality.py --recipes 4p9
    4p11)."""
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_recompute as k79
    from graphlap_tpu_torch.ops.nystrom import lobpcg_x0

    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_8mp(gt, patch=patch)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    x = fused_inputs(cfg, plan, img_d, dev)
    ctx, p, n, pp, nk, mk, sg = (x.ctx, x.p, x.n, x.pp, x.nk, x.mk, x.sg)
    y = x.k9[6]
    fd = ctx.f_t.shape[0]
    sfx = lanes_sfx(fd)
    feat_bytes = 2 * fd * (pp + nk)
    e7, e = pp * sg, pp * nk
    # K8's entry is a table load up to 64 lanes, kb_pair's exp past it
    cases = {
        "kb_strip" + sfx: (k79.kb_strip_cuda, k79.kb_strip_plain, x.k7,
                     bound(2 * fd * (pp + sg) + 4 * sg + 2 * e7,
                           2 * e7 * fd, 3 * e7)),
        "ext2_matvec" + sfx: (k79.ext2_matvec_cuda, k79.ext2_matvec_plain,
                        x.k8,
                        bound(feat_bytes + 8 * nk + 12 * pp, 2 * e * fd,
                              8 * e, e if fd > 64 else 0.0)),
        "finish_colstats" + sfx: (k79.finish_colstats_cuda,
                            k79.finish_colstats_plain, x.k9,
                            bound(feat_bytes + 4 * nk * (5 + mk)
                                  + 4 * pp * (mk + 2),
                                  2 * e * (fd + mk), 8 * e, e),
                            colstats_scales(y)),
    }
    phase("config4", f"workload and layouts at {H8}x{W8} (patch {patch}, "
          f"p={p}, p_pad={pp}, N={n}, {fd} feature lanes, gram columns "
          f"{sg}, V width {mk})", t0)
    # V's lean (its pass is K10's) and K8's s against the f64 sums of the
    # same bf16 tile entries: required
    run_cases(cases, rows, {"finish_colstats" + sfx: (0, n, False, True),
                            "ext2_matvec" + sfx: (1, n, True, True,
                                                  ext2_recompute_f64)},
              {"kb_strip" + sfx: (kb_library, "a cuBLAS composition, not one call: "
                            "torch.mm(fa_aug, f_t) bf16 in, f32 out, then "
                            "bf16(max(d2, 0)), exp, the bf16 entry, the scale "
                            "by bf16(cols), the bf16 cast")})

    # the rest of the K7 cross: the bf16-in / f32-out gram GEMM that follows
    # the emitter (cuda_recompute._gram) on its output
    t0 = time.perf_counter()
    kb = k79.kb_strip_cuda(*cases["kb_strip" + sfx][2])
    ms_gram = cuda_ms(lambda: k79._gram(kb), 5)
    ms_k7 = rows["kb_strip" + sfx]["ms"]
    del kb
    phase("kernel", f"kb_strip cross: emitter {ms_k7:.3f} ms + gram GEMM "
          f"{ms_gram:.3f} ms ((p_pad, {sg}) x ({sg}, p_pad), bf16 in, f32 "
          f"out); the emitter is {ms_k7 / (ms_k7 + ms_gram):.3f} of the "
          f"cross", t0)
    rows["kb_strip" + sfx]["gram_gemm_ms"] = ms_gram

    # K8's u and s apart, u signed: tile entries that flip and another sum
    # order scatter u both ways; an accumulation that rounds toward zero
    # pulls every row of an all-positive u low
    t0 = time.perf_counter()
    (u_k, s_k), (u_p, s_p) = (f(*cases["ext2_matvec" + sfx][2]) for f in
                              (k79.ext2_matvec_cuda, k79.ext2_matvec_plain))
    r = ((u_k - u_p) / u_p.abs().clamp_min(1e-30))[:p]
    u_diag = dict(u_rel=float((u_k - u_p).abs().max() / u_p.abs().max()),
                  s_rel=float((s_k - s_p).abs().max() / s_p.abs().max()),
                  u_row_rel_mean=float(r.mean()),
                  u_row_rel_median=float(r.median()),
                  u_rows_low=float((r < 0).float().mean()))
    phase("kernel", f"ext2_matvec apart: u {u_diag['u_rel']:.3e}, s "
          f"{u_diag['s_rel']:.3e} of max |plain|; u rows (kernel - plain) / "
          f"plain: mean {u_diag['u_row_rel_mean']:.3e}, median "
          f"{u_diag['u_row_rel_median']:.3e}, share below "
          f"{u_diag['u_rows_low']:.4f}", t0)
    require(SIGNED_BAND[0] < u_diag["u_rows_low"] < SIGNED_BAND[1],
            "ext2_matvec: u is biased to one side of its plain version")
    info["ext2_matvec_apart" + sfx] = u_diag
    del u_k, s_k, u_p, s_p

    # K9's V error in two parts: its s against the plain s, and its V
    # against the plain V formed from the kernel's own s
    t0 = time.perf_counter()
    parts = k9_parts(k79, cases["finish_colstats" + sfx][2], n)
    phase("kernel", f"finish_colstats apart: s {parts['s_rel']:.3e} of max "
          f"|plain s|, above plain on {parts['s_above']:.4f} of the columns "
          f"that differ, bf16(s) != plain's on {parts['cb_flips']:.3e}; V "
          f"{parts['v_rel']:.3e} of max |plain V| = the V pass on its own s "
          f"{parts['v_pass_rel']:.3e} + the s difference through the plain "
          f"V {parts['s_part_rel']:.3e} (bar 2^-7 = {2.0 ** -7:.3e}); its "
          f"worst column: |V| {parts['worst_v']:.4f} of max, s "
          f"{parts['worst_s_rel']:.2e} from plain, plain s "
          f"{parts['worst_edge']:.2e} from a bf16 rounding boundary", t0)
    info["finish_colstats_apart" + sfx] = parts
    del ctx, cases, x, y
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counters = {"kb_strip" + sfx: k79.kb_strip_cuda,
                "ext2_matvec" + sfx: k79.ext2_matvec_cuda,
                "finish_colstats" + sfx: k79.finish_colstats_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     f"8 MP, patch {patch}")
    launches.update(counts)
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    per_call = {k: v / RUNS for k, v in counts.items()}
    phase("e2e-8mp", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}); launches per call {per_call}", t0)
    require(res.image.shape == (H8, W8) and np.isfinite(res.image).all(),
            "8 MP output is not a finite (2048, 4096) image")
    require(psnr_out > psnr_in + 1.0, "8 MP denoise gain under 1 dB")

    t0 = time.perf_counter()
    z_plain, _ = _filter_channel(img_d, idx_d, cfg, plain=True)
    z_plain = z_plain.cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("plain", f"8 MP kernel path vs plain path on the card: {d_db:.5f} "
          f"dB, max |diff| {d_max:.3e} (bar 0.05 dB, 2e-2)", t0)
    require(d_db <= 0.05 and d_max <= 2e-2, "8 MP kernel path != plain path")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small = gt.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=16,
        sinkhorn_iters=4, streaming=True, block_cols=2048, use_pallas=True,
        sinkhorn_coarse=4, sinkhorn_polish=1, gram_coarse=4,
        fused_finish=True, affinity_dtype="bfloat16", patch_size=patch)
    im_s, nz_s = noisy_image(gt, 96, 96)
    pl_s = gt.make_plan(nz_s, small)
    x0 = lobpcg_x0(pl_s.p, small.num_eigvecs, "cpu")
    idx_s = pl_s.idx_a.astype(np.int64)
    z_cpu, _ = _filter_channel(torch.as_tensor(nz_s), torch.as_tensor(idx_s),
                               small, x0=x0)
    z_gpu, _ = _filter_channel(torch.as_tensor(nz_s, device=dev),
                               torch.as_tensor(idx_s, device=dev), small,
                               x0=x0.to(dev))
    z_cpu, z_gpu = z_cpu.numpy(), z_gpu.cpu().numpy()
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"96x96 recompute: card kernels vs CPU plain: {s_db:.5f} "
          f"dB, max |diff| {s_max:.3e}; PSNR {gt.psnr(im_s, nz_s):.3f} -> "
          f"{gt.psnr(im_s, z_gpu):.3f} dB", t0)
    require(np.isfinite(z_gpu).all() and s_db <= 0.05 and s_max <= 2e-2,
            "96x96 recompute card run != CPU plain run")
    info["config4" + sfx] = dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                           psnr_out=psnr_out, launches_per_call=per_call,
                           plain_path_db=d_db, plain_path_max=d_max,
                           small_db=s_db, small_max=s_max)


def entry_table(dev, info) -> None:
    """The aug K5/K6 kernel's tile entry and K7's against their evaluation
    at every one of the 65536 bf16(d2) patterns, on the card: route 1 (the
    K5/K6 kernel's table lookup) and K7's kb_pair (kexp on bf16(d2)) must
    equal route 0 (kb_aug, the expf the plain route's entry matches)
    everywhere. Printed beside: the live range read off route 0
    (the patterns whose entry is neither 1.0 nor 0: the clamp a table of
    the live patterns only would need), and the patterns where K10's exp
    (kexp: one FMUL, one MUFU ex2) differs from route 0, which it could
    replace the table only at 0."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    t0 = time.perf_counter()
    ref, got = (k56.aug_entries(route, dev) for route in (0, 1))
    d2 = (torch.arange(65536, dtype=torch.int32, device=dev) << 16).view(
        torch.float32)
    kx = (k79.kexp_bf16_cuda(d2).view(torch.int16).to(torch.int32) & 0xFFFF)
    pos = ref[:0x7F81]                    # +0 .. +inf
    one, zero = 0x3F80, 0
    lo = int((pos != one).nonzero()[0]) - 1
    hi = int((pos != zero).nonzero()[-1]) + 1
    bad = int((got != ref).sum())
    bad_neg = int((ref[0x8000:] != one).sum())
    kexp_bad = int((kx != ref).sum())
    k7_bad = int((k79.kb_entries(dev) != ref).sum())
    phase("table", f"aug entry at 65536 bf16(d2) patterns: table lookup != "
          f"kb_aug on {bad} (required 0); live range off the card's kb_aug "
          f"{lo:#06x} .. {hi:#06x} (1.0 at and below, 0 at and above); "
          f"negative patterns not 1.0: {bad_neg}; kexp (FMUL + MUFU ex2) != "
          f"kb_aug on {kexp_bad}; K7's entry (kb_pair) != kb_aug on {k7_bad} "
          f"(required 0)", t0)
    require(bad == 0, "the aug entry table differs from kb_aug")
    require(k7_bad == 0, "K7's tile entry differs from kb_aug")
    info["aug_entry_table"] = dict(mismatches=bad, live_lo=lo, live_hi=hi,
                                   negative_not_one=bad_neg,
                                   kexp_mismatches=kexp_bad,
                                   kb_strip_mismatches=k7_bad)


def config3(gt, dev, rows, launches, info, patch=5):
    """Config 3's per-channel sharpen (make_workload_cfg3) with an NLM
    ``patch`` x ``patch`` patch: the aug K5/K6 at channel 0's shapes, the
    path end to end with the reference's three sharpen bars (which the
    reference meets at every patch: at 9 x 9 and 11 x 11 PSNR 30.49 ->
    28.97 / 28.95 dB, gradient-energy ratio 1.237 -> 1.615 / 1.616, SSIM
    0.874 at 256^2, scripts/reference_quality.py --recipes 3p9 3p11), the
    plain path, and 48x48x3 against the CPU. At 7 x 7, 9 x 9 and 11 x 11
    (the 64-, 96- and 128-lane kernels) the rows are named ``*_d64``,
    ``*_d96``, ``*_d128``; the entry table is checked once, at 5 x 5."""
    from graphlap_tpu_torch.metrics import ssim
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    t0 = time.perf_counter()
    sfx = lanes_sfx(PATCH_LANES[patch])
    names = ("matvec" + sfx, "rmatvec" + sfx)
    cfg, img, noisy, plan = make_workload_cfg3(gt, patch)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d[..., 0].contiguous(), idx_d, cfg)
    require(ctx.fa_aug is not None, "config 3 did not reach the aug layout")
    require(ctx.f_t.shape[0] == PATCH_LANES[patch],
            "config 3's aug layout has another feature depth")
    phase("config3", f"workload and channel-0 layouts at {H3}x{W3}x3 (patch "
          f"{patch}, {ctx.f_t.shape[0]} feature lanes, p="
          f"{ctx.p}, p_pad={ctx.fa_aug.shape[0]}, N={ctx.n_pad}, "
          f"n_pad_k={ctx.f_t.shape[1]}; {cfg.filter_name} "
          f"{cfg.filter_param}, {cfg.filter_mode}, sinkhorn_coarse "
          f"{cfg.sinkhorn_coarse}, polish {cfg.sinkhorn_polish})", t0)
    if patch == 5:
        entry_table(dev, info)
    run_cases(*matvec_cases(ctx, dev, names, rows))
    del ctx
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counters = {names[0]: k56.matvec_cuda, names[1]: k56.rmatvec_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     f"config-3, patch {patch}")
    launches.update(counts)
    per_call = {k: v / RUNS for k, v in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    ge_in, ge_out = (grad_energy(noisy) / grad_energy(img),
                     grad_energy(res.image) / grad_energy(img))
    ss = ssim(img, res.image)
    phase("e2e-cfg3", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB; gradient-energy ratio "
          f"{ge_in:.4f} -> {ge_out:.4f}; SSIM {ss:.4f}; launches per call "
          f"{per_call}", t0)
    require(res.image.shape == (H3, W3, 3) and np.isfinite(res.image).all(),
            "config-3 output is not a finite (1024, 1024, 3) image")
    require(per_call == {names[0]: 6, names[1]: 6},
            "config 3 should launch K5 and K6 six times each a call")
    require(ge_out > ge_in + 0.05, "config-3 sharpen is net-smoothing")
    require(ss > 0.75, "config-3 SSIM under 0.75")
    require(psnr_out > psnr_in - 3.0, "config-3 PSNR fell by over 3 dB")

    t0 = time.perf_counter()
    z_plain = np.stack([_filter_channel(img_d[..., c].contiguous(), idx_d,
                                        cfg, plain=True)[0].cpu().numpy()
                        for c in range(3)], axis=-1)
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("plain", f"config-3 kernel path vs plain path on the card: "
          f"{d_db:.5f} dB, max |diff| {d_max:.3e} (bar 0.05 dB, 2e-2)", t0)
    require(d_db <= 0.05 and d_max <= 2e-2, "config-3 kernel path != plain")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small = cfg.replace(sample_rho=0.05, block_cols=1152, sinkhorn_coarse=4)
    im_s = gt.make_test_image(48, 48, channels=3)
    nz_s = np.clip(gt.add_gaussian_noise(im_s, 0.03, seed=3), 0,
                   1).astype(np.float32)
    pl_s = gt.make_plan(nz_s, small)
    z_cpu = gt.filter_image(nz_s, small, plan=pl_s, device="cpu").image
    z_gpu = gt.filter_image(nz_s, small, plan=pl_s, device=dev).image
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"48x48x3 sharpen: card kernels vs CPU plain: {s_db:.5f} "
          f"dB, max |diff| {s_max:.3e}", t0)
    require(np.isfinite(z_gpu).all() and s_db <= 0.05 and s_max <= 2e-2,
            "48x48x3 card run != CPU plain run")
    info["config3" + sfx] = dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                           psnr_out=psnr_out, grad_ratio_in=ge_in,
                           grad_ratio_out=ge_out, ssim=ss,
                           launches_per_call=per_call, plain_path_db=d_db,
                           plain_path_max=d_max, small_db=s_db,
                           small_max=s_max)


def config4q(gt, dev, rows, launches, info, patch=5):
    """The 8 MP matvec denoise (make_workload_8mp_matvec) with an NLM
    ``patch`` x ``patch`` patch: the f32 K5/K6 at the path's shapes, the
    path end to end (gain > 5 dB, which the reference shows at every patch:
    +6.84 / +6.59 dB at 9 x 9 / 11 x 11 on 256 x 512,
    scripts/reference_quality.py --recipes 4qp9 4qp11), the plain path,
    and the recipe at 96x96 against the CPU. At 7 x 7, 9 x 9 and 11 x 11
    (the 64-, 96- and 128-lane kernels) the rows are named ``*_d64``,
    ``*_d96``, ``*_d128``."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    t0 = time.perf_counter()
    sfx = lanes_sfx(PATCH_LANES[patch])
    names = ("matvec_f32" + sfx, "rmatvec_f32" + sfx)
    cfg, img, noisy, plan = make_workload_8mp_matvec(gt, patch)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    require(ctx.fa_aug is None and ctx.f_t.dtype == torch.float32
            and ctx.f_t.shape[0] == PATCH_LANES[patch],
            "the 8 MP matvec denoise did not reach the f32 layout")
    phase("config4q", f"workload and layouts at {H8}x{W8} (patch {patch}, "
          f"{ctx.f_t.shape[0]} feature lanes, p={ctx.p}, p_pad="
          f"{ctx.fa_pad.shape[0]}, N={ctx.n_pad}, h {cfg.h}, "
          f"{cfg.filter_name} {cfg.filter_mode}, f32 tiles, sinkhorn_coarse "
          f"{cfg.sinkhorn_coarse}, polish {cfg.sinkhorn_polish})", t0)
    cases, _, signed = matvec_cases(ctx, dev, names, rows)
    run_cases(cases, rows, signed, k56_f32_library(names))
    # the f32 K5/K6's three-part split cross: each output against its sum in
    # f64, the kernel's max and p99 relative error within 1.5x the plain
    # version's, and its share below f64 in (0.35, 0.65)
    t0 = time.perf_counter()
    for name, keep, what in ((names[0], ctx.p, "matvec"),
                             (names[1], ctx.n, "rmatvec")):
        kern, plain, args = cases[name][:3]
        ref64 = f64_sums(args[0], args[1], what, args[2])[:keep]
        got = kern(*args)[:keep]
        rec = sums_f64_check(name, got, plain(*args)[:keep], ref64)
        rec["share_below"] = signed_stats(got, ref64, True)["share_below"]
        phase("sums", f"{name}: share below f64 {rec['share_below']:.4f} "
              f"(required in (0.35, 0.65))", t0)
        require(0.35 < rec["share_below"] < 0.65,
                f"{name}: leans against its f64 sums")
        rows[name]["f64"] = rec
        del ref64, got
    del ctx, cases
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counters = {names[0]: k56.matvec_cuda, names[1]: k56.rmatvec_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     f"8 MP matvec, patch {patch}")
    launches.update(counts)
    per_call = {k: v / RUNS for k, v in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e-8mp-mv", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}); launches per call {per_call}", t0)
    require(res.image.shape == (H8, W8) and np.isfinite(res.image).all(),
            "8 MP matvec output is not a finite (2048, 4096) image")
    require(per_call == {names[0]: 2, names[1]: 2},
            "the 8 MP matvec denoise should launch K5 and K6 twice a call")
    require(psnr_out > psnr_in + 5.0, "8 MP matvec denoise gain under 5 dB")

    t0 = time.perf_counter()
    z_plain = _filter_channel(img_d, idx_d, cfg, plain=True)[0].cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("plain", f"8 MP matvec kernel path vs plain path on the card: "
          f"{d_db:.6f} dB, max |diff| {d_max:.3e} (bar 0.02 dB, 2e-3)", t0)
    require(d_db <= 0.02 and d_max <= 2e-3, "8 MP matvec kernel path != plain")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    # 96x96 on the recipe (its f32 tiles and matvec route), card kernels
    # against the plain versions on the CPU
    t0 = time.perf_counter()
    small = cfg.replace(sample_rho=0.05, block_cols=2048, sinkhorn_coarse=4)
    im_s, nz_s = noisy_image(gt, 96, 96)
    pl_s = gt.make_plan(nz_s, small)
    z_cpu = gt.filter_image(nz_s, small, plan=pl_s, device="cpu").image
    z_gpu = gt.filter_image(nz_s, small, plan=pl_s, device=dev).image
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"96x96 matvec denoise (patch {patch}): card kernels vs "
          f"CPU plain: {s_db:.6f} dB, max |diff| {s_max:.3e} (bar 0.02 dB, "
          f"2e-3)", t0)
    require(np.isfinite(z_gpu).all() and s_db <= 0.02 and s_max <= 2e-3,
            "96x96 matvec denoise card run != CPU plain run")
    info["config4q" + sfx] = dict(walls_s=walls, peak_bytes=peak,
                                  psnr_in=psnr_in, psnr_out=psnr_out,
                                  launches_per_call=per_call,
                                  plain_path_db=d_db, plain_path_max=d_max,
                                  small_db=s_db, small_max=s_max)


def config4t(gt, dev, rows, launches, info, patch=5):
    """The 8 MP turbo recipe (make_workload_8mp_turbo) with an NLM ``patch``
    x ``patch`` patch: K10 at the path's shapes, the path end to end, and
    the recipe at 96x96 against the CPU. At 7, 9 and 11 (64-, 96- and
    128-lane layouts) the rows are named ``*_d64``, ``*_d96``, ``*_d128``:
    there the turbo recipe is K10's path. The gain required, 1 dB, holds at
    every patch (scripts/reference_quality.py --recipes 4tp9 4tp11)."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_recompute as k79
    from graphlap_tpu_torch.ops.nystrom import lobpcg_x0

    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_8mp_turbo(gt, patch)
    require(not cfg.fused_finish and cfg.sinkhorn_polish == 0,
            "the turbo recipe should miss the fused finish")
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    p, n = ctx.p, ctx.n_pad
    pp, nk = ctx.fa_pad.shape[0], ctx.f_t.shape[1]
    mk = ms._m_kernel(cfg.num_eigvecs)
    sfx = lanes_sfx(ctx.f_t.shape[0])
    cases, rows, signed = colstats_v_cases(ctx, cfg, img_d, dev, rows,
                                           "colstats_v" + sfx)
    na, nb = cases["colstats_v" + sfx][2][5:7]
    phase("config4t", f"turbo workload and layouts at {H8}x{W8} (patch "
          f"{patch}, {ctx.f_t.shape[0]} feature lanes, p={p}, "
          f"p_pad={pp}, N={n}, sinkhorn_coarse {cfg.sinkhorn_coarse}, "
          f"gram_coarse {cfg.gram_coarse}, polish {cfg.sinkhorn_polish}, "
          f"V width {mk})", t0)
    run_cases(cases, rows, signed)

    # the tile entry's exp (kexp: one FMUL, one MUFU ex2) against expf over
    # one full stage of the V pass, 64 sample rows by every column, on the
    # same d2 values: the share of bf16 entries that differ
    t0 = time.perf_counter()
    fa_s = ctx.fa_pad[:64].float()
    d2 = torch.clamp(na[:64, None] + nb[None, :]
                     - 2.0 * (fa_s @ ctx.f_t.float()), min=0.0)
    flips = float((k79.kexp_bf16_cuda(d2)
                   != k79.kexp_bf16_plain(d2)).float().mean())
    phase("kernel", f"colstats_v exp: bf16(kexp) != bf16(expf) on "
          f"{flips:.3e} of one stage's {d2.numel()} entries (64 rows x "
          f"{nk} columns; expected below 1e-3)", t0)
    rows["colstats_v" + sfx]["exp_flip_share"] = flips
    del d2, fa_s, ctx, cases, na, nb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fused = (k79.ext2_matvec_cuda, k79.finish_colstats_cuda)
    for fn in fused:
        fn.launches = 0
    counters = {"kb_strip" + sfx: k79.kb_strip_cuda,
                "colstats_v" + sfx: k79.colstats_v_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     f"8 MP turbo, patch {patch}")
    launches["colstats_v" + sfx] = counts["colstats_v" + sfx]
    per_call = {k: v / RUNS for k, v in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e-8mp-turbo", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}); launches per call {per_call}; K8/K9 "
          f"launches {[fn.launches for fn in fused]}", t0)
    require(res.image.shape == (H8, W8) and np.isfinite(res.image).all(),
            "8 MP turbo output is not a finite (2048, 4096) image")
    require(per_call == {"kb_strip" + sfx: 1, "colstats_v" + sfx: 1}
            and all(fn.launches == 0 for fn in fused),
            "the turbo recipe should launch K7 and K10 once a call, K8/K9 "
            "never")
    require(psnr_out > psnr_in + 1.0, "8 MP turbo denoise gain under 1 dB")

    t0 = time.perf_counter()
    z_plain, _ = _filter_channel(img_d, idx_d, cfg, plain=True)
    z_plain = z_plain.cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("plain", f"8 MP turbo kernel path vs plain path on the card: "
          f"{d_db:.5f} dB, max |diff| {d_max:.3e} (bar 0.05 dB, 2e-2)", t0)
    require(d_db <= 0.05 and d_max <= 2e-2, "8 MP turbo kernel path != plain")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small = gt.PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=16,
        sinkhorn_iters=4, streaming=True, block_cols=2048, use_pallas=True,
        sinkhorn_coarse=4, gram_coarse=4, affinity_dtype="bfloat16",
        patch_size=patch)
    im_s, nz_s = noisy_image(gt, 96, 96)
    pl_s = gt.make_plan(nz_s, small)
    x0 = lobpcg_x0(pl_s.p, small.num_eigvecs, "cpu")
    idx_s = pl_s.idx_a.astype(np.int64)
    z_cpu, _ = _filter_channel(torch.as_tensor(nz_s), torch.as_tensor(idx_s),
                               small, x0=x0)
    z_gpu, _ = _filter_channel(torch.as_tensor(nz_s, device=dev),
                               torch.as_tensor(idx_s, device=dev), small,
                               x0=x0.to(dev))
    z_cpu, z_gpu = z_cpu.numpy(), z_gpu.cpu().numpy()
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"96x96 unfused recompute: card kernels vs CPU plain: "
          f"{s_db:.5f} dB, max |diff| {s_max:.3e}", t0)
    require(np.isfinite(z_gpu).all() and s_db <= 0.05 and s_max <= 2e-2,
            "96x96 unfused card run != CPU plain run")
    info["config4t" + sfx] = dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                            psnr_out=psnr_out, launches_per_call=per_call,
                            plain_path_db=d_db, plain_path_max=d_max,
                            small_db=s_db, small_max=s_max)


def staged_plain(cfg, noisy, plan, dev):
    """filter_image_staged's schedule on a gray image (its stage functions:
    the scales, the unfused eigensolve, the apply) through the kernels'
    plain versions on the card: the image."""
    from graphlap_tpu_torch.models import streaming as ms

    img = torch.as_tensor(noisy, device=dev)
    idx = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img, idx, cfg, plain=True)
    s = ms._normalize_streaming(ctx, cfg)
    fac = ms._eigensolve_streaming(img, ctx, s, cfg)
    return ms._apply_factor(fac, idx, cfg, *noisy.shape)[0].cpu().numpy()


def staged_one(gt, tag, cfg, img, noisy, plan, dev, counters,
               keys=("normalize", "eigensolve", "filter"), bars=(0.05, 2e-2),
               against_plain=False):
    """filter_image_staged: a warm-up, then RUNS timed calls with every
    count set to 0 just before them; its timing keys must be ``keys``, and
    it is held to filter_image on the same config within ``bars`` (dB, max
    |diff|), or with ``against_plain`` to the same staged schedule through
    the plain versions on the card (``staged_plain``; its gap to
    filter_image printed). Returns the phase's record."""
    gt.filter_image_staged(noisy, cfg, plan=plan, device=dev)   # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stage_walls, walls = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        res = gt.filter_image_staged(noisy, cfg, plan=plan, device=dev)
        walls.append(time.perf_counter() - t0)
        stage_walls.append(res.timings)
    peak = torch.cuda.max_memory_allocated()
    per_call = {k: fn.launches / RUNS for k, fn in counters.items()}
    fused = gt.filter_image(noisy, cfg, plan=plan, device=dev).image
    f_db = abs(gt.psnr(img, res.image) - gt.psnr(img, fused))
    f_max = float(np.abs(res.image - fused).max())
    ref = staged_plain(cfg, noisy, plan, dev) if against_plain else fused
    what = "its plain path" if against_plain else "filter_image"
    d_db = abs(gt.psnr(img, res.image) - gt.psnr(img, ref))
    d_max = float(np.abs(res.image - ref).max())
    eig = [t["eigensolve"] for t in stage_walls]
    gap = (f"; vs filter_image {f_db:.5f} dB, max |diff| {f_max:.3e} (not "
           f"required: the two schedules part at this patch in the "
           f"reference too)" if against_plain else "")
    phase("staged", f"{tag}: stage walls {stage_walls}; eigensolve min "
          f"{min(eig):.6f} s; call walls {[round(w, 6) for w in walls]} s; "
          f"peak memory {peak / 2**30:.3f} GiB; launches per call "
          f"{per_call}; vs {what} {d_db:.5f} dB, max |diff| "
          f"{d_max:.3e} (bar {bars[0]} dB, {bars[1]:.0e}){gap}")
    require(set(res.timings) == set(keys), f"{tag}: staged timings keys")
    require(np.isfinite(res.image).all() and res.image.shape == noisy.shape,
            f"{tag}: staged output is not a finite image of the input shape")
    require(all(c > 0 for c in per_call.values()),
            f"{tag}: the staged path never launched one of {list(counters)}")
    require(d_db <= bars[0] and d_max <= bars[1],
            f"{tag}: staged image != {what}")
    out = dict(stage_walls_s=stage_walls, walls_s=walls, peak_bytes=peak,
               launches_per_call=per_call, vs_filter_image_db=f_db,
               vs_filter_image_max=f_max)
    if against_plain:
        out.update(vs_plain_db=d_db, vs_plain_max=d_max)
    return out


def staged(gt, dev, info):
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_8mp(gt)
    info["staged_config4"] = staged_one(
        gt, "config 4 (8 MP)", cfg, img, noisy, plan, dev,
        {"matvec": k56.matvec_cuda, "rmatvec": k56.rmatvec_cuda,
         "kb_strip": k79.kb_strip_cuda, "colstats_v": k79.colstats_v_cuda})
    phase("staged", "config 4 done", t0)
    torch.cuda.empty_cache()
    # at 7 x 7: the polish on the 64-lane aug K5/K6, the 64-lane K7 and K10.
    # There the unfused schedule parts from the fused one by ~0.3 dB in the
    # reference too (tests/test_torch_wide.py's staged 7 x 7 test prints
    # both gaps on the CPU), so it is held to its own plain path
    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_8mp_p7(gt)
    info["staged_config4_d64"] = staged_one(
        gt, "config 4 at 7x7 (8 MP)", cfg, img, noisy, plan, dev,
        {"matvec_d64": k56.matvec_cuda, "rmatvec_d64": k56.rmatvec_cuda,
         "kb_strip_d64": k79.kb_strip_cuda,
         "colstats_v_d64": k79.colstats_v_cuda}, against_plain=True)
    phase("staged", "config 4 at 7x7 done", t0)
    torch.cuda.empty_cache()
    # at 11 x 11: the polish on the 128-lane aug K5/K6, the 128-lane K7 and
    # K10, held to its own plain path as at 7 x 7
    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_8mp(gt, patch=11)
    info["staged_config4_d128"] = staged_one(
        gt, "config 4 at 11x11 (8 MP)", cfg, img, noisy, plan, dev,
        {"matvec_d128": k56.matvec_cuda, "rmatvec_d128": k56.rmatvec_cuda,
         "kb_strip_d128": k79.kb_strip_cuda,
         "colstats_v_d128": k79.colstats_v_cuda}, against_plain=True)
    phase("staged", "config 4 at 11x11 done", t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload(gt)
    info["staged_config2"] = staged_one(
        gt, "config 2 (512x512)", cfg, img, noisy, plan, dev,
        {"affinity_strip": k1.affinity_strip_cuda})
    phase("staged", "config 2 done", t0)


def make_workload_dense(gt, cfg=None, size=H):
    """bench.py's f32 twin of the headline (``CONFIG2.replace(use_pallas=
    True)``, bench.py:279) on bench.make_workload's image: (cfg, clean
    image, noisy f32 image, plan)."""
    cfg = gt.CONFIG2.replace(use_pallas=True) if cfg is None else cfg
    img, noisy = noisy_image(gt, size, size)
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def k1_dense_cases(cfg, noisy, plan, dev):
    """K1 as the dense path calls it on the f32 twin: config 2's features in
    permuted [A; B] order, K_AA's rows against K_AB's N - p columns."""
    from graphlap_tpu_torch.ops import affinity as taff
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    perm = torch.as_tensor(plan.perm.astype(np.int64), device=dev)
    fp = taff.extract_features(torch.as_tensor(noisy, device=dev), cfg)[perm]
    fa, fb = fp[:plan.p].contiguous(), fp[plan.p:].contiguous()
    p, n, d = fa.shape[0], fb.shape[0], fa.shape[1]
    e = p * n
    # the bytes: the f32 store plus the features read once; the operations:
    # the "highest" cross as three fp16 tensor passes over the 32 padded
    # lanes, ~8 f32 operations and one exp an entry (as K1's config-2 row)
    return {"affinity_strip_f32": (
        k1.affinity_strip_cuda, k1.affinity_strip_plain,
        (fa, fb, torch.float32, None),
        bound(4 * e + 4 * d * (p + n), 3 * 2 * e * 32, 8 * e, e))}


def dense_pair(gt, tag, cfg, img, noisy, plan, dev, counters, bars):
    """The dense path at full size: ``drive`` (one K1 launch a call), the
    denoise gain, and the kernel path against the plain path on the card
    within ``bars``. Returns the phase's record."""
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    t0 = time.perf_counter()
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters, tag)
    per_call = {k: c / RUNS for k, c in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e-dense", f"{tag}: walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB; launches per call "
          f"{per_call}", t0)
    require(res.image.shape == noisy.shape and np.isfinite(res.image).all(),
            f"{tag}: output is not a finite image of the input shape")
    require(psnr_out > psnr_in + 5.0, f"{tag}: denoise gain under 5 dB")
    require(all(c == 1 for c in per_call.values()),
            f"{tag}: not one K1 launch a call")

    def to(a):
        return torch.as_tensor(a.astype(np.int64), device=dev)

    t0 = time.perf_counter()
    z_plain, _ = _filter_channel(torch.as_tensor(noisy, device=dev),
                                 to(plan.idx_a), cfg, plain=True,
                                 perm=to(plan.perm),
                                 inv_perm=to(plan.inv_perm))
    z_plain = z_plain.cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    phase("e2e-dense", f"{tag}: kernel vs plain path on the card: {d_db:.5f} "
          f"dB, max |diff| {d_max:.3e} (bar {bars[0]} dB, {bars[1]:.0e})", t0)
    require(d_db <= bars[0] and d_max <= bars[1],
            f"{tag}: kernel path != plain path")
    return dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                psnr_out=psnr_out, launches_per_call=per_call,
                plain_path_db=d_db, plain_path_max=d_max)


def dense(gt, dev, rows, launches, info):
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    f32_bars, bf16_bars = (0.02, 2e-3), (0.05, 2e-2)
    t0 = time.perf_counter()
    cfg, img, noisy, plan = make_workload_dense(gt)
    cases = k1_dense_cases(cfg, noisy, plan, dev)
    fa, fb = cases["affinity_strip_f32"][2][:2]
    phase("dense", f"f32 twin at {H}x{W}: p={plan.p}, K_AB {fa.shape[0]} x "
          f"{fb.shape[0]} (N - p % 4 = {fb.shape[0] % 4}, % 8 = "
          f"{fb.shape[0] % 8}: padded rows, a view)", t0)
    run_cases(cases, rows, library=strip_library())

    t0 = time.perf_counter()
    got = k1.affinity_strip_cuda(fa, fb, torch.float32, torch.bfloat16)
    again = k1.affinity_strip_cuda(fa, fb, torch.float32, torch.bfloat16)
    ref = k1.affinity_strip_plain(fa, fb, torch.float32, torch.bfloat16)
    err = float((got.float() - ref.float()).abs().max())
    same = bool(torch.equal(got, again))
    view = not got.is_contiguous()
    del got, again, ref, cases
    torch.cuda.empty_cache()
    ms_b = cuda_ms(lambda: k1.affinity_strip_cuda(fa, fb, torch.float32,
                                                  torch.bfloat16), 5)
    phase("kernel", f"affinity_strip bf16 store at the dense shape: "
          f"max_abs_err {err:.3e} (tol {TOL['affinity_strip']:.1e}), two launches bit for "
          f"bit: {same}, padded-row view: {view}; kernel {ms_b:.3f} ms", t0)
    require(err <= TOL["affinity_strip"] and same,
            "affinity_strip bf16 store at the dense shape")
    rows["affinity_strip_bf16_dense"] = dict(max_abs_err=err, ms=ms_b,
                                             bit_repeat=same, view=view)
    del fa, fb
    torch.cuda.empty_cache()

    counter = {"affinity_strip_f32": k1.affinity_strip_cuda}
    info["dense_f32"] = dense_pair(gt, "dense f32 twin", cfg, img, noisy, plan,
                                   dev, counter, f32_bars)
    launches["affinity_strip_f32"] = round(
        info["dense_f32"]["launches_per_call"]["affinity_strip_f32"] * RUNS)
    torch.cuda.empty_cache()
    cfg_b = cfg.replace(affinity_dtype="bfloat16_store")
    info["dense_bf16_store"] = dense_pair(
        gt, "dense bfloat16_store", cfg_b, img, noisy, plan, dev,
        {"affinity_strip": k1.affinity_strip_cuda}, bf16_bars)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    info["staged_dense"] = staged_one(
        gt, "dense f32 twin", cfg, img, noisy, plan, dev, counter,
        keys=("affinity", "normalize", "eigensolve", "filter"),
        bars=f32_bars)
    phase("staged", "dense f32 twin done", t0)
    torch.cuda.empty_cache()

    for tag, size, small in (("config 1", 128, gt.CONFIG1),
                             ("config 2 dense", 96, cfg)):
        t0 = time.perf_counter()
        _, im_s, nz_s, pl_s = make_workload_dense(gt, small, size)
        card = gt.filter_image(nz_s, small, plan=pl_s, device=dev).image
        cpu = gt.filter_image(nz_s, small, plan=pl_s, device="cpu").image
        s_db = abs(gt.psnr(im_s, card) - gt.psnr(im_s, cpu))
        s_max = float(np.abs(card - cpu).max())
        phase("small", f"{tag} at {size}x{size}: card vs CPU plain: "
              f"{s_db:.5f} dB, max |diff| {s_max:.3e}; PSNR "
              f"{gt.psnr(im_s, nz_s):.3f} -> {gt.psnr(im_s, card):.3f} dB", t0)
        require(np.isfinite(card).all() and s_db <= f32_bars[0]
                and s_max <= f32_bars[1], f"{tag}: card run != CPU plain run")
        info[f"small_{tag.replace(' ', '_')}"] = dict(db=s_db, max=s_max)


def k1_dense_coord_case(cfg, image, plan, dev):
    """(name, case) of K1's coordinate cross with the f32 store as the
    dense path calls it with ``use_pallas`` and a spatial term: ``cfg``'s
    features of ``image`` in permuted [A; B] order, K_AA's rows against
    K_AB's N - p columns (``affinity_strip_coord_f32`` and lanes_sfx). Its
    bound: the f32 store and the features read once; the IEEE f32 cross
    over the live lanes (2 flop a lane an entry), one exp an entry."""
    from graphlap_tpu_torch.ops import affinity as taff
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    perm = torch.as_tensor(plan.perm.astype(np.int64), device=dev)
    img_d = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    fp = taff.extract_features(img_d, cfg)[perm]
    fa, fb = fp[:plan.p].contiguous(), fp[plan.p:].contiguous()
    p, n, d = fa.shape[0], fb.shape[0], fa.shape[1]
    e, live = p * n, -(-d // 4) * 4
    name = "affinity_strip_coord_f32" + lanes_sfx(-(-d // 32) * 32)
    return name, (k1.affinity_strip_cuda, k1.affinity_strip_plain,
                  (fa, fb, torch.float32, None, True),
                  bound(4 * e + 4 * d * (p + n), 0, 2 * live * e, e))


def cli_phase(gt, dev, rows, launches, info):
    """The port's CLI (graphlap_tpu_torch.cli.main) as a user runs it, on
    the clean 512^2 test image saved as a PNG (an empty -opts_file, so no
    rc file of the home directory is read): (i) recipe A at 11 x 11
    (-preset fast with -patch 11 -spatial_h 8 -sample 0.02): its record's
    config_hash that of make_workload_cfg2_bilateral(gt, 11), K1's
    coordinate cross once a stage that builds the strip (normalize and
    eigensolve: two a channel, as staged config 2), and the output PNG
    within 2e-2 + 1/255 of filter_image on the same config and noised
    image, its PSNR within 0.05 dB; (ii) the dense route with -pallas at 9 x
    9 and 11 x 11: first K1's coordinate cross with the f32 store at its
    K_AB shape (5243 x 256901) against its plain version (run_cases: twice
    bit for bit, timed beside its composition) and against f64 on 512
    sample rows (k1_coord_slab), then the CLI run: rc 0, one K1 launch a
    channel, the wall and the PSNR printed."""
    import tempfile

    from graphlap_tpu_torch import cli
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        src, opts, log = tmp / "clean.png", tmp / "opts", tmp / "runs.jsonl"
        gt.save_image(str(src), gt.make_test_image(H, W))
        opts.write_text("")
        clean = gt.load_image(str(src))
        image = np.clip(gt.add_gaussian_noise(clean, 0.1, 1), 0, 1)
        common = ["-f", str(src), "-kernel", "nlm", "-spatial_h", "8",
                  "-sample", "0.02", "-noise", "0.1", "-seed", "1",
                  "-log_view", "-json_log", str(log), "-opts_file", str(opts)]

        def run(tag, argv):
            k1.affinity_strip_cuda.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(common + argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_k1 = k1.affinity_strip_cuda.launches
            rec = json.loads(log.read_text().splitlines()[-1])
            phase("cli", f"{tag}: rc {rc}, wall {wall:.3f} s (the process's "
                  f"first call of the config), stage walls "
                  f"{rec['timings_s']}, K1 launches {n_k1}; PSNR "
                  f"{rec['psnr_noisy_db']:.3f} -> "
                  f"{rec['psnr_filtered_db']:.3f} dB", t0)
            require(rc == 0, f"{tag}: the CLI returned {rc}")
            return rec, n_k1, wall

        # (i) recipe A at 11 x 11
        png = tmp / "recipe_a.png"
        rec, n_k1, wall = run("recipe A at 11x11", [
            "-patch", "11", "-preset", "fast", "-o", str(png)])
        cfg = make_workload_cfg2_bilateral(gt, 11)[0]
        require(rec["config_hash"] == cfg.config_hash(),
                "the CLI's 11x11 run did not resolve to recipe A")
        require(n_k1 == 2, "the CLI's recipe A run did not launch K1's "
                "coordinate cross once in each of its two strip stages")
        ref = gt.filter_image(image, cfg, plan=gt.make_plan(image, cfg),
                              device=dev).image
        got = gt.load_image(str(png))
        d_max = float(np.abs(got - ref).max())
        d_db = abs(rec["psnr_filtered_db"] - gt.psnr(clean, ref))
        phase("cli", f"recipe A at 11x11: the output PNG against "
              f"filter_image on the same image: max |diff| {d_max:.3e} (bar "
              f"{2e-2 + 1 / 255:.3e}), PSNR {d_db:.5f} dB apart (bar 0.05)")
        require(got.shape == ref.shape and d_max <= 2e-2 + 1 / 255
                and d_db <= 0.05, "the CLI's recipe A output != filter_image")
        out["recipe_a_p11"] = dict(wall_s=wall, k1_launches=n_k1,
                                   timings_s=rec["timings_s"],
                                   psnr=rec["psnr_filtered_db"],
                                   vs_filter_image_max=d_max,
                                   vs_filter_image_db=d_db)
        # (ii) the dense route at 9 x 9 and 11 x 11
        for patch in (9, 11):
            t0 = time.perf_counter()
            cfg = gt.PipelineConfig(kernel="nlm", patch_size=patch,
                                    spatial_h=8.0, sample_rho=0.02,
                                    use_pallas=True)
            plan = gt.make_plan(image, cfg)
            name, case = k1_dense_coord_case(cfg, image, plan, dev)
            fa, fb = case[2][:2]
            phase("cli", f"dense route at {patch}x{patch}: K_AB "
                  f"{fa.shape[0]} x {fb.shape[0]}, {fa.shape[1]} lanes", t0)
            run_cases({name: case}, rows, library=strip_library())
            rows[name]["f64"] = k1_coord_slab(
                fa[torch.linspace(0, fa.shape[0] - 1, 512,
                                  device=dev).long()], fb,
                f"{name} (512 sample rows)")
            del fa, fb, case
            torch.cuda.empty_cache()
            rec, n_k1, wall = run(f"dense route at {patch}x{patch}",
                                  ["-patch", str(patch), "-pallas"])
            require(rec["config_hash"] == cfg.config_hash(),
                    f"the CLI's dense {patch}x{patch} run resolved to "
                    f"another config")
            require(n_k1 == 1 and set(rec["timings_s"]) == {
                "affinity", "normalize", "eigensolve", "filter"},
                f"the CLI's dense {patch}x{patch} run: not one K1 launch on "
                f"the dense path")
            launches[name] = n_k1
            out[f"dense_p{patch}"] = dict(wall_s=wall, k1_launches=n_k1,
                                          timings_s=rec["timings_s"],
                                          psnr=rec["psnr_filtered_db"])
    info["cli"] = out


def make_workload_bilateral(gt, h=H8, w=W8):
    """The bilateral 8 MP denoise: tuned_config(CONFIG1.replace(streaming=
    True, sample_cap=4096), 2048*4096, "fast") (f32 tiles, the route
    tests/test_presets.py pins for spatial_h > 0) on config 4's image:
    (cfg, clean image, noisy f32 image, plan)."""
    img, noisy = noisy_image(gt, h, w)
    cfg = gt.tuned_config(gt.CONFIG1.replace(streaming=True, sample_cap=4096),
                          h * w, "fast")
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_8mp_nlm_bilateral(gt, patch=7):
    """Recipe B, the 8 MP spectral bilateral denoise with an NLM ``patch``
    x ``patch`` patch (the CLI's -kernel nlm -patch 7 -spatial_h 8):
    tuned_config(CONFIG2.replace(streaming=True, sample_cap=4096,
    patch_size=patch, spatial_h=8.0), 2048*4096, "fast"): f32 tiles, h
    0.15, coarse Sinkhorn and gram 1/64, one polish, the fused finish,
    LOBPCG; 28 live lanes of 32 at 5 x 5, 52 of 64 at 7 x 7, 84 of 96 at 9
    x 9, 124 of 128 at 11 x 11: (cfg, clean image, noisy f32 image,
    plan)."""
    img, noisy = noisy_image(gt, H8, W8)
    cfg = gt.tuned_config(gt.CONFIG2.replace(
        streaming=True, sample_cap=4096, patch_size=patch, spatial_h=8.0),
        H8 * W8, "fast")
    require(cfg.affinity_dtype == "float32" and cfg.fused_finish,
            "recipe B did not resolve to f32 tiles and the fused finish")
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def make_workload_8mp_nlm_bilateral_matvec(gt, patch=7):
    """Recipe C: recipe B's base through denoise_tuned(0.1) and
    tuned_config "fast": the 8 MP matvec denoise with an NLM ``patch`` x
    ``patch`` patch and a spatial term, f32 tiles, h 0.1: (cfg, clean
    image, noisy f32 image, plan)."""
    img, noisy = noisy_image(gt, H8, W8)
    base = gt.CONFIG2.replace(streaming=True, sample_cap=4096,
                              patch_size=patch, spatial_h=8.0)
    cfg = gt.tuned_config(gt.denoise_tuned(base, 0.1), H8 * W8, "fast")
    return cfg, img, noisy, gt.make_plan(noisy, cfg)


def kb_f32_library(fa, f_t, cols, aug, live):
    """K7 f32's yardstick: torch.mm(fa, f_t) in f32 at "highest" (no TF32),
    the norms, the clamp, exp and the column scale. Timed beside the
    kernel; the port never calls it."""
    d2 = ((fa * fa).sum(1)[:, None] + (f_t * f_t).sum(0)[None, :]
          - 2.0 * torch.mm(fa, f_t)).clamp_(min=0.0)
    return torch.exp_(d2.neg_()).mul_(cols[None, :])


def k56_f32_composition(fa, f_t, x, rows_side, chunk=1 << 18):
    """The f32 K5 (``rows_side`` False: x = v of f_t's columns, K v) or K6
    (True: x = t of fa's rows, K^T t) as a cuBLAS composition over column
    chunks: torch.addmm in f32 at "highest" (no TF32) with the column norms,
    the row norms, the clamp, exp, then the product with v or t. The f32
    and coordinate K5/K6's yardstick; the port never calls it."""
    na = (fa * fa).sum(1)
    nb = (f_t * f_t).sum(0)
    n = f_t.shape[1]
    out = torch.zeros(n if rows_side else fa.shape[0], dtype=torch.float32,
                      device=fa.device)
    for j in range(0, n, chunk):
        sl = slice(j, j + chunk)
        k = torch.addmm(nb[None, sl], fa, f_t[:, sl], alpha=-2.0)
        k.add_(na[:, None]).clamp_(min=0.0).neg_().exp_()
        if rows_side:
            out[sl] = x @ k
        else:
            out.addmv_(k, x[sl])
        del k
    return out


def k56_f32_library(names) -> dict:
    """run_cases' library entry of an f32 K5/K6 pair (names: K5's, K6's):
    k56_f32_composition on the kernels' arguments, timed over LIBRARY_REPS
    calls (each ~0.1-1 s at 8 MP)."""
    what = ("a cuBLAS composition, not one call: torch.addmm(nb, fa, f_t, "
            "alpha=-2) in f32 at \"highest\" (no TF32) over 2^18-column "
            "chunks, + na, the clamp, exp, then the product with v (K5) or t "
            "(K6)")
    return {names[0]: (lambda fa, f_t, v, *_: k56_f32_composition(
                fa, f_t, v, False), what, LIBRARY_REPS),
            names[1]: (lambda fa, f_t, t, *_: k56_f32_composition(
                fa, f_t, t, True), what, LIBRARY_REPS)}


def k8_f32_composition(fa, f_t, t2, bm, chunk=1 << 18):
    """The f32 K8 as a cuBLAS composition over column chunks: torch.addmm
    in f32 at "highest" (no TF32) with the column norms, the row norms, the
    clamp, exp, kbt = t2 @ k, s = bm / sqrt(max(kbt_r kbt_c, eps)), then u
    += k @ s. K8 f32's yardstick; the port never calls it. -> (u, s)."""
    na = (fa * fa).sum(1)
    nb = (f_t * f_t).sum(0)
    n = f_t.shape[1]
    u = torch.zeros(fa.shape[0], dtype=torch.float32, device=fa.device)
    s = torch.empty(n, dtype=torch.float32, device=fa.device)
    for j in range(0, n, chunk):
        sl = slice(j, j + chunk)
        k = torch.addmm(nb[None, sl], fa, f_t[:, sl], alpha=-2.0)
        k.add_(na[:, None]).clamp_(min=0.0).neg_().exp_()
        kbt = t2 @ k
        s[sl] = bm[sl] / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
        u.addmv_(k, s[sl])
        del k
    return u, s


K8_F32_LIBRARY = ("a cuBLAS composition, not one call: torch.addmm(nb, fa, "
                  "f_t, alpha=-2) in f32 at \"highest\" (no TF32) over "
                  "2^18-column chunks, + na, the clamp, exp, kbt = t2 @ k, s, "
                  "then u += k @ s")


def f64_tile(fa, f_t, rows, cols=None, chunk=1 << 20):
    """The f32-class tile at sample rows ``rows`` x columns ``cols`` (all by
    default) of the padded layouts, evaluated in f64 from the same f32
    features: (R, C) f64."""
    a = fa[rows].double()
    b = f_t if cols is None else f_t[:, cols]
    na = (a * a).sum(1)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float64,
                      device=fa.device)
    for j in range(0, b.shape[1], chunk):
        bb = b[:, j:j + chunk].double()
        d2 = na[:, None] + (bb * bb).sum(0)[None, :] - 2.0 * (a @ bb)
        out[:, j:j + chunk] = torch.exp(-d2.clamp_(min=0.0))
    return out


def slab_check(label, kern, plain, ref64, required=True):
    """A tile slab against its f64 evaluation over the live entries (f64 K >
    1e-6): the kernel's max and p99 |dK| at most 1.5x the plain f32
    version's (two correct f32 evaluations differ by the cancellation
    error itself, so the f64 value is the yardstick). Returns the record."""
    live = ref64 > 1e-6

    def stats(x):
        d = (x.double() - ref64)[live].abs()
        sub = d[::max(1, d.numel() >> 22)]       # torch.quantile's bound
        return float(d.max()), float(torch.quantile(sub, 0.99))
    k, pl = stats(kern), stats(plain)
    phase("slab", f"{label}: |K - f64| over {int(live.sum())} live entries of "
          f"a {tuple(ref64.shape)} slab: kernel max {k[0]:.3e}, p99 "
          f"{k[1]:.3e}; plain f32 max {pl[0]:.3e}, p99 {pl[1]:.3e}"
          f"{' (kernel required <= 1.5x plain)' if required else ''}")
    if required:
        require(k[0] <= 1.5 * pl[0] and k[1] <= 1.5 * pl[1],
                f"{label}: the tile against f64 is past 1.5x its plain "
                f"version's error")
    return dict(kernel_max=k[0], kernel_p99=k[1], plain_max=pl[0],
                plain_p99=pl[1], live=int(live.sum()))


def k1_coord_slab(fa, fb, label):
    """K1's coordinate cross (f32 store) on (p, d) x (n, d) features against
    their f64 evaluation, within 1.5x the plain version's error
    (slab_check); the split-fp16 cross (not on these paths) printed beside.
    Returns the record."""
    from graphlap_tpu_torch.ops import cuda_affinity as k1

    a64, b64 = fa.double(), fb.double()
    ref = torch.exp(-((a64 * a64).sum(1)[:, None] + (b64 * b64).sum(1)[None]
                      - 2.0 * a64 @ b64.T).clamp_(min=0.0))
    del a64, b64
    pl = k1.affinity_strip_plain(fa, fb)
    out = {"coord": slab_check(f"{label}, coordinate cross",
                               k1.affinity_strip_cuda(fa, fb, coords=True),
                               pl, ref),
           "split": slab_check(f"{label}, split-fp16 cross (not on this "
                               f"path)", k1.affinity_strip_cuda(fa, fb), pl,
                               ref, required=False)}
    del ref, pl
    torch.cuda.empty_cache()
    return out


def f64_sums(fa, f_t, what, *vecs, chunk=16384):
    """K5 (``what`` "matvec", vecs (v,)), K6 ("rmatvec", (t,)), K8
    ("ext2", (t2, bm)), K10 ("colstats", (gr, c)) or K9 ("finish", (gr, t,
    s_pre, bm)) with the tile and every sum in f64, from the same f32
    features, over column chunks: the output, (u, s) for K8, (V, the sums
    of V's terms' magnitudes) for K10 and (V, its terms, s) for K9 (the
    column vectors c, s_pre and bm of f_t's columns)."""
    a = fa.double()
    na = (a * a).sum(1)
    n = f_t.shape[1]
    f64 = dict(dtype=torch.float64, device=fa.device)
    if what in ("colstats", "finish"):
        gr = vecs[0].double()
        out = torch.empty((n, gr.shape[1]), **f64)
        terms = torch.empty((n, gr.shape[1]), **f64)
    else:
        out = torch.zeros(fa.shape[0] if what != "rmatvec" else n, **f64)
    s = torch.empty(n, **f64) if what in ("ext2", "finish") else None
    for j in range(0, n, chunk):
        sl = slice(j, j + chunk)
        b = f_t[:, sl].double()
        k = torch.exp(-(na[:, None] + (b * b).sum(0)[None]
                        - 2.0 * (a @ b)).clamp_(min=0.0))
        if what == "matvec":
            out += k @ vecs[0][sl].double()
        elif what == "rmatvec":
            out[sl] = vecs[0].double() @ k
        elif what in ("colstats", "finish"):
            if what == "finish":
                ks = vecs[1].double() @ k
                s[sl] = torch.sqrt(vecs[2][sl].double() / torch.clamp(
                    ks, min=1e-30)) * vecs[3][sl].double()
                c = s[sl]
            else:
                c = vecs[1][sl].double()
            k *= c[None]
            out[sl] = k.T @ gr
            terms[sl] = k.abs_().T @ gr.abs()
        else:
            kbt = vecs[0].double() @ k
            s[sl] = vecs[1][sl].double() / torch.sqrt(
                torch.clamp(kbt[0] * kbt[1], min=1e-30))
            out += k @ s[sl]
    if what == "colstats":
        return out, terms
    if what == "finish":
        return out, terms, s
    return out if s is None else (out, s)


def aug_f64_sums(fa, f_t, what, x, chunk=16384):
    """The aug K5 (``what`` "matvec") or K6 ("rmatvec") on the plain
    version's bf16 tile entries and the vector rounded to bf16, as the
    wrapper rounds it, every product and sum in f64, over column chunks."""
    from graphlap_tpu_torch.ops.cuda_recompute import _tile_plain

    xr = x.to(torch.bfloat16).double()
    n = f_t.shape[1]
    out = torch.zeros(fa.shape[0] if what == "matvec" else n,
                      dtype=torch.float64, device=fa.device)
    for j in range(0, n, chunk):
        sl = slice(j, j + chunk)
        k = _tile_plain(fa, f_t[:, sl], True).double()
        if what == "matvec":
            out += k @ xr[sl]
        else:
            out[sl] = xr @ k
    return out


def sums_f64_check(label, got, plain, ref64, scale=None):
    """A kernel's sums against their f64 evaluation: its max and p99
    relative error at most 1.5x the plain f32 version's, relative to |f64|
    (over the entries where it is not 0) or, for sums whose terms cancel,
    to ``scale``, the f64 sum of the terms' magnitudes. Returns the
    record."""
    den = ref64.abs() if scale is None else scale
    keep = den != 0

    def stats(x):
        d = ((x.double() - ref64).abs() / den)[keep]
        return float(d.max()), float(torch.quantile(
            d[::max(1, d.numel() >> 22)], 0.99))
    k, pl = stats(got), stats(plain)
    over = "" if scale is None else " (over the sum of its terms' magnitudes)"
    phase("sums", f"{label}: relative error against f64{over} over "
          f"{int(keep.sum())} outputs: kernel max {k[0]:.3e}, p99 {k[1]:.3e};"
          f" plain f32 max {pl[0]:.3e}, p99 {pl[1]:.3e} (kernel required <= "
          f"1.5x plain)")
    require(k[0] <= 1.5 * pl[0] + 1e-7 and k[1] <= 1.5 * pl[1] + 1e-7,
            f"{label}: the sums against f64 are past 1.5x their plain "
            f"version's error")
    return dict(kernel_max=k[0], kernel_p99=k[1], plain_max=pl[0],
                plain_p99=pl[1])


def bilateral_sums(cases, p, n, sfx=""):
    """K8's u and s and the coordinate K5/K6's outputs at the path's shapes
    (the run_cases inputs, names ending in ``sfx``) against their f64
    evaluation. Returns the record."""
    out = {}
    k8 = "ext2_matvec_f32" + sfx
    fa, f_t, t2, bm = cases[k8][2][:4]
    u64, s64 = f64_sums(fa, f_t, "ext2", t2, bm)
    (u, s), (u_p, s_p) = (f(*cases[k8][2]) for f in cases[k8][:2])
    out[k8 + "_u"] = sums_f64_check(k8 + " u", u[:p], u_p[:p], u64[:p])
    out[k8 + "_s"] = sums_f64_check(k8 + " s", s[:n], s_p[:n], s64[:n])
    del u64, s64, u, s, u_p, s_p
    for name, keep in (("matvec_coord" + sfx, p), ("rmatvec_coord" + sfx, n)):
        kern, plain, args = cases[name][:3]
        ref = f64_sums(args[0], args[1], name.split("_")[0], args[2])
        out[name] = sums_f64_check(name, kern(*args)[:keep],
                                   plain(*args)[:keep], ref[:keep])
    out.update(colstats_f64_checks(cases, n, sfx))
    return out


def colstats_f64_checks(cases, n, sfx=""):
    """The f32 K9's V and s and K10's V (the run_cases inputs, names ending
    in ``sfx``) against their f64 evaluation on an even subset of 2^20 of
    the n columns (f64_sums): V over the sums of its terms' magnitudes, s
    over |s|, each within 1.5x the plain version's max and p99 error, and
    each one's share below f64 in SIGNED_BAND (the plain version's printed
    beside it). Returns the record."""
    out = {}
    for name, kind in (("finish_colstats_f32" + sfx, "finish"),
                       ("colstats_v_f32" + sfx, "colstats")):
        kern, plain, args = cases[name][:3]
        got, ref = kern(*args), plain(*args)
        fa, f_t = args[:2]
        cols = torch.arange(0, n, max(1, n >> 20), device=fa.device)
        ft_c = f_t[:, cols].contiguous()
        if kind == "finish":
            t, s_pre, bm, gr = args[2:6]
            v64, terms, s64 = f64_sums(fa, ft_c, kind, gr, t, s_pre[cols],
                                       bm[cols])
        else:
            gr, c = args[2], args[4]
            v64, terms = f64_sums(fa, ft_c, kind, gr, c[cols])
            s64 = None
        del ft_c
        live = gr.abs().sum(0) > 0           # V's columns past m are zero
        checks = [("V", got[0][cols][:, live], ref[0][cols][:, live],
                   v64[:, live], terms[:, live])]
        if s64 is not None:
            checks.append(("s", got[3][cols], ref[3][cols], s64, None))
        for what, g, r, r64, sc in checks:
            label = f"{name} {what} on {cols.numel()} columns"
            rec = sums_f64_check(label, g, r, r64, sc)
            st, st_p = signed_stats(g, r64, False), signed_stats(r, r64, False)
            phase("signed", f"{label}: (kernel - f64) sign(f64) / max |f64|: "
                  f"mean {st['mean']:.3e}, median {st['median']:.3e}, share "
                  f"below {st['share_below']:.4f} (required in "
                  f"{SIGNED_BAND}); the plain version's share below f64 "
                  f"{st_p['share_below']:.4f}")
            require(SIGNED_BAND[0] < st["share_below"] < SIGNED_BAND[1],
                    f"{label}: biased to one side of its f64 sums")
            out[f"{name}_{what}"] = dict(rec, share_below=st["share_below"],
                                         plain_share_below=st_p["share_below"])
        del got, ref, v64, terms, s64, checks
        torch.cuda.empty_cache()
    return out


def bilateral_slabs(ctx, ft_g, dev):
    """Each f32 kernel's tile and the coordinate K1 / K5/K6 cross against
    f64 on slabs of the path's own features: K7 emits its tile (cols = 1);
    K10 with a one-hot gr and c = 1 writes V_jm = k(row_m, j), a sum of one
    term; K9 the same scaled by its s; K8 with one-hot t2 rows gives s_j =
    1 / sqrt(k_qj^2), so k = 1 / s; K6 with a one-hot t gives k(q, j); K1
    on 64 sample rows by 2^20 pixels (k1_coord_slab). Returns the
    record."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    fa, f_t, live, p = ctx.fa_pad, ctx.f_t, ctx.live, ctx.p
    pp, nk, n = fa.shape[0], f_t.shape[1], ctx.n
    rows = torch.linspace(0, p - 1, 64, device=dev).long()
    out = {}
    # K7: rows x every gram column
    one = torch.ones(ft_g.shape[1], device=dev)
    ref = f64_tile(fa, ft_g, rows)
    out["kb_strip_f32"] = slab_check(
        "kb_strip_f32", k79.kb_strip_cuda(fa, ft_g, one, False, live)[rows],
        k79.kb_strip_plain(fa, ft_g, one, False)[rows], ref)
    # K10 and K9: V = the tile's rows (K9: times s), every column
    valid = torch.zeros(nk, device=dev)
    valid[:n] = 1.0
    gr = torch.zeros((pp, 64), device=dev)
    gr[rows, torch.arange(64, device=dev)] = 1.0
    na, nb = ms._sq_norms_pad(ctx)
    ref = f64_tile(fa, f_t, rows, torch.arange(n, device=dev))
    args = (fa, f_t, gr, valid, valid, na, nb)
    out["colstats_v_f32"] = slab_check(
        "colstats_v_f32", k79.colstats_v_cuda(*args, live=live)[0][:n].T,
        k79.colstats_v_plain(*args)[0][:n].T, ref)
    # the one-hot checks take the last sample row: the grid's far corner,
    # where the coordinates (and the cancellation) are largest
    q = rows[-1]
    t = torch.zeros(pp, device=dev)
    t[q] = 1.0
    args = (fa, f_t, t, valid, valid, gr, valid, na, nb)
    kv, ks = k79.finish_colstats_cuda(*args, live=live)[0::3]
    pv, ps = k79.finish_colstats_plain(*args)[0::3]
    out["finish_colstats_f32"] = slab_check(
        "finish_colstats_f32 (V / s)", (kv[:n] / ks[:n, None]).T,
        (pv[:n] / ps[:n, None]).T, ref)
    del kv, pv
    # K9's ks pass on row q: s = sqrt(1 / k), so k = 1 / s^2
    out["finish_colstats_f32_ks"] = slab_check(
        "finish_colstats_f32 (ks: 1 / s^2)", (1.0 / ks[:n] ** 2)[None],
        (1.0 / ps[:n] ** 2)[None], ref[-1:])
    # K8: t_r = t_c = e_q, so kbt_r = kbt_c = k(q, j) and s = 1 / k
    t2 = torch.zeros((2, pp), device=dev)
    t2[:, q] = 1.0
    ks8 = k79.ext2_matvec_cuda(fa, f_t, t2, valid, False, live)[1][:n]
    ps8 = k79.ext2_matvec_plain(fa, f_t, t2, valid, False)[1][:n]
    out["ext2_matvec_f32"] = slab_check(
        "ext2_matvec_f32 (1 / s)", (1.0 / ks8)[None], (1.0 / ps8)[None],
        ref[-1:])
    # K6 with the coordinate cross (and the split one beside): k(q, j)
    got = k56.rmatvec_cuda(fa, f_t, t, False, live, True)[:n][None]
    pl = k56.rmatvec_plain(fa, f_t, t, False)[:n][None]
    out["rmatvec_coord"] = slab_check("rmatvec_coord", got, pl, ref[-1:])
    split = k56.rmatvec_cuda(fa, f_t, t, False, live, False)[:n][None]
    out["rmatvec_split"] = slab_check(
        "rmatvec with the split-fp16 cross (not on this path; the fault "
        "the coordinate cross repairs)", split, pl, ref[-1:], required=False)
    del ref, got, pl, split
    torch.cuda.empty_cache()
    # K1 on the path's features: 64 sample rows by 2^20 pixels, f32 store
    fa3 = ctx.feats_a[rows.clamp(max=p - 1)].contiguous()
    fb3 = ctx.feats_pad[:1 << 20].contiguous()
    k1_slab = k1_coord_slab(fa3, fb3, "affinity_strip")
    out["affinity_coord"], out["affinity_split"] = (k1_slab["coord"],
                                                    k1_slab["split"])
    # K1's two crosses timed on 512 sample rows by 2^20 pixels of the 8 MP
    # coordinates (f32 store: 2.15 GB, 0.64 ms at 3.35 TB/s); the paths
    # that run K1 on coordinates are 512^2 ones (recipe A, the CLI's dense
    # route)
    fa5 = ctx.feats_a[torch.linspace(0, p - 1, 512, device=dev).long()]
    fa5 = fa5.contiguous()
    t_k1 = {name: cuda_ms(lambda c=c: k1.affinity_strip_cuda(fa5, fb3,
                                                             coords=c), 5)
            for name, c in (("coord", True), ("split", False))}
    b_k1 = bound(4 * 512 * fb3.shape[0], 0, 2 * live * 512 * fb3.shape[0],
                 512 * fb3.shape[0])
    phase("kernel", f"affinity_strip on coordinates (512 x {fb3.shape[0]}, "
          f"f32 store): coordinate cross {t_k1['coord']:.3f} ms, split-fp16 "
          f"cross {t_k1['split']:.3f} ms, bound {b_k1[0]:.3f} ms ({b_k1[1]})")
    out["affinity_coord_ms"] = dict(t_k1, bound_ms=b_k1[0])
    return out


def bilateral_rows(gt, dev, rows, cfg, noisy, plan, live_req, tag, sfx=""):
    """The f32 K7-K10 and the coordinate K5/K6 at a bilateral streaming
    recipe's 8 MP shapes on its own layouts (``live_req`` live lanes; the
    rows named with ``sfx``, "_d64", "_d96" or "_d128" past 32 lanes):
    against their
    plain versions with their leans required, twice bit for bit, timed; K7
    beside its cuBLAS composition and the f32 gram GEMM after it; K8's
    and K5/K6's sums against f64, and every tile and K1's coordinate cross
    on slabs against f64 (each within 1.5x the plain version's error).
    Returns the record of the sums and slabs."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    t0 = time.perf_counter()
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    require(ctx.fa_aug is None and ctx.f_t.dtype == torch.float32
            and ctx.coords and ctx.live == live_req
            and ctx.f_t.shape[0] == -(-live_req // 32) * 32,
            f"{tag} did not reach the f32 coordinate layout of {live_req} "
            f"live lanes")
    p, n, live = ctx.p, ctx.n_pad, ctx.live
    pp, nk = ctx.fa_pad.shape[0], ctx.f_t.shape[1]
    mk = ms._m_kernel(cfg.num_eigvecs)
    jidx = torch.as_tensor(ms.gram_sample_idx(n, cfg.gram_coarse,
                                              cfg.gram_jitter_seed),
                           dtype=torch.int64, device=dev)
    ft_g = ctx.f_t[:, jidx].contiguous()
    sg = ft_g.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    bm = torch.zeros(nk, device=dev)
    bm[:n] = ctx.b_mask
    t2 = torch.zeros((2, pp), device=dev)
    t2[:, :p] = 0.5 + rand(2, p)
    tv = torch.zeros(pp, device=dev)
    tv[:p] = 0.5 + rand(p)
    gr = torch.zeros((pp, mk), device=dev)
    gr[:p, :cfg.num_eigvecs] = (rand(p, cfg.num_eigvecs) - 0.5) * 0.02
    y = torch.zeros(nk, device=dev)
    y[:ctx.n] = img_d.reshape(-1)
    cols = torch.zeros(nk, device=dev)
    cols[:n] = (0.5 + rand(n)) * ctx.b_mask
    na, nb = ms._sq_norms_pad(ctx)
    s_pre = (0.5 + rand(nk)) * bm
    v = 0.5 + rand(nk)
    fa, f_t = ctx.fa_pad, ctx.f_t
    e7, e = pp * sg, pp * nk
    feat = 4 * live * (pp + nk)           # the live lanes, read once
    # bounds: bytes read and written once; f32 operations (an FMA is 2) of
    # the live-lane cross (2 live an entry) and the consumer's FMAs; one exp
    # an entry
    cases = {
        "kb_strip_f32" + sfx: (k79.kb_strip_cuda, k79.kb_strip_plain,
                               (fa, ft_g, 0.5 + rand(sg), False, live),
                               bound(4 * live * (pp + sg) + 4 * sg + 4 * e7,
                                     0, 2 * live * e7 + 2 * e7, e7)),
        "ext2_matvec_f32" + sfx: (k79.ext2_matvec_cuda, k79.ext2_matvec_plain,
                                  (fa, f_t, t2, bm, False, live),
                                  bound(feat + 8 * nk + 12 * pp, 0,
                                        (2 * live + 6) * e, e)),
        "finish_colstats_f32" + sfx: (
            lambda *a: k79.finish_colstats_cuda(*a, live=live),
            k79.finish_colstats_plain, (fa, f_t, tv, s_pre, bm, gr, y, na, nb),
            bound(feat + 4 * nk * (5 + mk) + 4 * pp * (mk + 2),
                  F32_V_PASSES * 2 * (mk + 8) * e, 2 * live * e, e),
            colstats_scales(y)),
        "colstats_v_f32" + sfx: (
            lambda *a: k79.colstats_v_cuda(*a, live=live),
            k79.colstats_v_plain, (fa, f_t, gr, y, cols, na, nb),
            bound(feat + 4 * nk * (4 + mk) + 4 * pp * (mk + 1),
                  F32_V_PASSES * 2 * mk * e, 2 * live * e, e),
            colstats_scales(y)),
        "matvec_coord" + sfx: (k56.matvec_cuda, k56.matvec_plain,
                               (fa, f_t, v, False, live, True),
                               bound(feat + 4 * (nk + pp), 0,
                                     (2 * live + 2) * e, e)),
        "rmatvec_coord" + sfx: (k56.rmatvec_cuda, k56.rmatvec_plain,
                                (fa, f_t, tv, False, live, True),
                                bound(feat + 4 * (nk + pp), 0,
                                      (2 * live + 2) * e, e)),
    }
    phase(tag, f"workload and layouts at {H8}x{W8} (p={p}, p_pad={pp}, "
          f"N={n}, live lanes {live} of {f_t.shape[0]}, gram columns {sg}, V "
          f"width {mk}; sinkhorn_coarse {cfg.sinkhorn_coarse}, gram_coarse "
          f"{cfg.gram_coarse}, polish {cfg.sinkhorn_polish}, fused_finish "
          f"{cfg.fused_finish}, {cfg.solver})", t0)
    # the leans: K8's u (rows) and s, K9's and K10's V, K5/K6's outputs
    signed = {"ext2_matvec_f32" + sfx: [(0, p, True, True),
                                        (1, n, True, True)],
              "finish_colstats_f32" + sfx: (0, n, False, True),
              "colstats_v_f32" + sfx: (0, n, False, True),
              "matvec_coord" + sfx: (0, p, True, True),
              "rmatvec_coord" + sfx: (0, ctx.n, True, True)}
    k7 = "kb_strip_f32" + sfx
    phase(tag, f"the coordinate K5/K6 read {k56._coord_lv(fa, True, live)} "
          f"lanes of {fa.shape[1]}, the f32 K8 {k79._lanes(live, fa.shape[1])} "
          f"(their live lanes rounded up to 4)")
    run_cases(cases, rows, signed,
              {k7: (kb_f32_library, "a cuBLAS composition, not one call: "
                    "torch.mm(fa, f_t) in f32 at \"highest\" (no TF32), the "
                    "norms, the clamp, exp and the column scale"),
               "ext2_matvec_f32" + sfx: (
                   lambda fa, f_t, t2, bm, *_: k8_f32_composition(
                       fa, f_t, t2, bm), K8_F32_LIBRARY, LIBRARY_REPS),
               **k56_f32_library(("matvec_coord" + sfx,
                                  "rmatvec_coord" + sfx))})
    # the rest of the f32 K7 cross: the f32 gram GEMM after the emitter
    t0 = time.perf_counter()
    kb = k79.kb_strip_cuda(*cases[k7][2])
    ms_gram = cuda_ms(lambda: k79._gram(kb), 3)
    ms_k7 = rows[k7]["ms"]
    del kb
    phase("kernel", f"{k7} cross: emitter {ms_k7:.3f} ms + f32 gram "
          f"GEMM {ms_gram:.3f} ms ((p_pad, {sg}) x ({sg}, p_pad) at "
          f"\"highest\", {2 * pp * pp * sg / ms_gram / 1e9:.2f} TFLOP/s)", t0)
    rows[k7]["gram_gemm_ms"] = ms_gram
    # the f32 K9 / K10's bounds count V and ks as F32_V_PASSES bf16 tensor
    # passes beside the FFMA cross; the design they replaced ran all of it
    # on the FP32 pipe
    for name, extra in (("finish_colstats_f32" + sfx, 2),
                        ("colstats_v_f32" + sfx, 0)):
        b_ms, _ = bound(0, 0, (2 * mk + 2 * live + extra) * e, e)
        rows[name]["ffma_bound_ms"] = b_ms
        phase("kernel", f"{name}: the f32 FFMA bound of the same work "
              f"{b_ms:.3f} ms (the bound above counts V and ks as "
              f"{F32_V_PASSES} bf16 tensor passes, the cross as f32 FFMA)")
    t0 = time.perf_counter()
    phase("slab", f"{tag}: sums and slabs against f64 ({live} live lanes)")
    rec = dict(sums=bilateral_sums(cases, p, n, sfx),
               slabs=bilateral_slabs(ctx, ft_g, dev))
    phase("slab", "done", t0)
    del ctx, cases, ft_g, t2, tv, gr, y, na, nb, s_pre, bm, cols, v, fa, f_t
    del img_d, idx_d
    torch.cuda.empty_cache()
    return rec


# live lanes of recipes B and C at each NLM patch (the patch and the
# coordinates, rounded up to 4)
NLM_COORD_LIVE = {5: 28, 7: 52, 9: 84, 11: 124}


def nlm_key(base: str, patch: int, sep: str = "_") -> str:
    """A recipe's record key or tag at an NLM patch: the 7 x 7 one as it
    was, the others with the patch."""
    return base if patch == 7 else f"{base}{sep}p{patch}"


def bilateral(gt, dev, rows, launches, info, patch=None):
    """The bilateral 8 MP denoise (make_workload_bilateral, gaussian, 4
    live lanes), or with ``patch`` 7, 9 or 11 its NLM twin, recipe B
    (make_workload_8mp_nlm_bilateral: 52, 84 or 124 live lanes of 64, 96 or
    128, rows named by lanes_sfx; at 7 x 7 the 28-lane rows of the 5 x 5
    twin kept in the phase's record): the f32 K7-K10 and the coordinate
    K5/K6 (bilateral_rows), the fused finish and the staged schedule end to
    end (past 7 x 7 the staged one held to its own plain path), and the
    recipe at 96x96 against the CPU (not at 9 x 9)."""
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    from graphlap_tpu_torch.ops import cuda_recompute as k79
    from graphlap_tpu_torch.ops.nystrom import lobpcg_x0

    sfx = "" if patch is None else lanes_sfx(PATCH_LANES[patch])
    key = "bilateral" if patch is None else nlm_key("bilateral_nlm_8mp",
                                                    patch)
    tag = "bilateral" if patch is None else nlm_key("bilateral-nlm-8mp",
                                                    patch, "-")
    if patch is None:
        cfg, img, noisy, plan = make_workload_bilateral(gt)
        rec = bilateral_rows(gt, dev, rows, cfg, noisy, plan, 4, tag)
        info["bilateral_sums"], info["bilateral_slabs"] = (rec["sums"],
                                                           rec["slabs"])
    elif patch == 7:
        # the 28-lane rows (NLM 5 x 5 and the coordinates: the kernels' LV
        # = 32 instantiations), each checked as the 64-lane rows are; no
        # frame at 5 x 5
        at28 = {}
        w5 = make_workload_8mp_nlm_bilateral(gt, patch=5)
        rec28 = bilateral_rows(gt, dev, at28, w5[0], w5[2], w5[3], 28,
                               f"{tag} at 5x5", "_l28")
        del w5
        torch.cuda.empty_cache()
        cfg, img, noisy, plan = make_workload_8mp_nlm_bilateral(gt, patch)
        rec = bilateral_rows(gt, dev, rows, cfg, noisy, plan, 52, tag, sfx)
        info[key + "_kernels"] = dict(rows_28=at28, f64_28=rec28,
                                      f64_52=rec)
    else:
        live = NLM_COORD_LIVE[patch]
        cfg, img, noisy, plan = make_workload_8mp_nlm_bilateral(gt, patch)
        info[key + "_kernels"] = {f"f64_{live}": bilateral_rows(
            gt, dev, rows, cfg, noisy, plan, live, tag, sfx)}
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)

    # filter_image: the fused finish, K8, K7, K9 once a call, K10 never
    t0 = time.perf_counter()
    k79.colstats_v_cuda.launches = 0
    counters = {"kb_strip_f32" + sfx: k79.kb_strip_cuda,
                "ext2_matvec_f32" + sfx: k79.ext2_matvec_cuda,
                "finish_colstats_f32" + sfx: k79.finish_colstats_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     f"{tag} 8 MP")
    launches.update(counts)
    per_call = {k: c / RUNS for k, c in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e-bilateral", f"walls {[round(w, 6) for w in walls]} s (min "
          f"{min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}); launches per call {per_call}; K10 "
          f"launches {k79.colstats_v_cuda.launches}", t0)
    require(res.image.shape == (H8, W8) and np.isfinite(res.image).all(),
            "bilateral output is not a finite (2048, 4096) image")
    require(all(c == 1 for c in per_call.values())
            and k79.colstats_v_cuda.launches == 0,
            "the bilateral fused finish should launch K8, K7 and K9 once a "
            "call and K10 never")
    # the recipe's quality is the reference's: at these decimations (coarse
    # Sinkhorn and gram 1/64, p = 4096) its output degenerates in
    # graphlap_tpu too (the gaussian recipe at 256x512 on the CPU: PSNR
    # 20.22 -> 5.25 dB, eigenvalues ~3e30; the NLM 7 x 7, 9 x 9 and 11 x 11
    # ones 20.22 -> 6.54, 6.62 and 6.63 dB, scripts/reference_quality.py;
    # ROADMAP.md Queue 3), so the phase prints the PSNR and holds the
    # kernels to their plain path, the 8 MP slabs and the 96x96 runs, not
    # to a denoise gain
    phase("e2e-bilateral", f"{tag}: denoise gain {psnr_out - psnr_in:.3f} "
          f"dB (not required: the recipe degenerates in the reference too); "
          f"top eigenvalues {np.asarray(res.eigvals)[:3].tolist()}")

    t0 = time.perf_counter()
    z_plain = _filter_channel(img_d, idx_d, cfg, plain=True)[0].cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    b_db, b_max, floor = plain_bars(gt, cfg, img, img_d, idx_d, z_plain, tag,
                                    patch is not None)
    phase("plain", f"{tag} 8 MP kernel path vs plain path on the card: "
          f"{d_db:.6f} dB, max |diff| {d_max:.3e} (bar {b_db:.4f} dB, "
          f"{b_max:.3e})", t0)
    require(d_db <= b_db and d_max <= b_max, f"{tag} kernel path != plain")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    # filter_image_staged: the unfused schedule (polish K5 + K6 with the
    # coordinate cross, K7, LOBPCG, K10), held to filter_image within the
    # fused-vs-unfused bars of config 4's staged run (another schedule of
    # the estimator: post-polish scales at the gram columns), past 7 x 7 to
    # its own plain path within them, as config 4's past 5 x 5
    t0 = time.perf_counter()
    st_counters = {"matvec_coord" + sfx: k56.matvec_cuda,
                   "rmatvec_coord" + sfx: k56.rmatvec_cuda,
                   "kb_strip_f32" + sfx: k79.kb_strip_cuda,
                   "colstats_v_f32" + sfx: k79.colstats_v_cuda}
    rec = staged_one(gt, f"{tag} (8 MP)", cfg, img, noisy, plan, dev,
                     st_counters, against_plain=patch in (9, 11))
    pc = rec["launches_per_call"]
    require(pc["kb_strip_f32" + sfx] == 1 and pc["colstats_v_f32" + sfx] == 1,
            f"the staged {tag} schedule should launch K7 and K10 once a call")
    for name in ("matvec_coord", "rmatvec_coord", "colstats_v_f32"):
        launches[name + sfx] = round(pc[name + sfx] * RUNS)
    info["staged_" + key] = rec
    phase("staged", f"{tag} done", t0)
    torch.cuda.empty_cache()

    # 96x96: the recipe written out (fused finish on and off), card kernels
    # against the plain versions on the CPU, the same LOBPCG start; not at
    # 9 x 9, to keep the script's time
    info[key] = dict(walls_s=walls, peak_bytes=peak, psnr_in=psnr_in,
                     psnr_out=psnr_out, launches_per_call=per_call,
                     plain_path_db=d_db, plain_path_max=d_max,
                     plain_floor=floor)
    if patch == 9:
        return
    t0 = time.perf_counter()
    im_s, nz_s = noisy_image(gt, 96, 96)
    small = {}
    kern = (dict(kernel="gaussian", h=0.2) if patch is None else
            dict(kernel="nlm", h=cfg.h, patch_size=patch))
    for fused in (True, False):
        cfg_s = gt.PipelineConfig(
            **kern, spatial_h=8.0, sample_rho=0.05,
            num_eigvecs=50, sinkhorn_iters=6, streaming=True, block_cols=2048,
            use_pallas=True, affinity_dtype="float32", sinkhorn_coarse=4,
            sinkhorn_polish=1, gram_coarse=4, solver="lobpcg",
            fused_finish=fused)
        pl_s = gt.make_plan(nz_s, cfg_s)
        x0 = lobpcg_x0(pl_s.p, cfg_s.num_eigvecs, "cpu")
        idx_s = pl_s.idx_a.astype(np.int64)
        z_cpu = _filter_channel(torch.as_tensor(nz_s), torch.as_tensor(idx_s),
                                cfg_s, x0=x0)[0].numpy()
        z_gpu = _filter_channel(torch.as_tensor(nz_s, device=dev),
                                torch.as_tensor(idx_s, device=dev), cfg_s,
                                x0=x0.to(dev))[0].cpu().numpy()
        s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
        s_max = float(np.abs(z_cpu - z_gpu).max())
        phase("small", f"96x96 {tag} (fused_finish {fused}): card kernels "
              f"vs CPU plain: {s_db:.6f} dB, max |diff| {s_max:.3e} (bar "
              f"0.02 dB, 2e-3)")
        require(np.isfinite(z_gpu).all() and s_db <= 0.02 and s_max <= 2e-3,
                "96x96 bilateral card run != CPU plain run")
        small[f"fused_{fused}"] = dict(db=s_db, max=s_max)
    phase("small", "done", t0)
    info[key]["small"] = small


def f32_floor(gt, cfg, img, img_d, idx_d, z_plain, tag):
    """The plain path's own f32 floor on a coordinate recipe: the same plain
    path on the card with the feature lanes in reverse order (the same
    function; every norm and cross sums in another order) against the
    plain path. On NLM features with (row, col) / 8 at 8 MP (|f|^2 ~
    3.3e5, an f32 ulp 0.03 in d2) two correct f32 evaluations of a tile
    entry differ by a few %, and a sparse recipe's output pixel, a weighted
    mean of a few samples, by as much as their spread times that. Returns
    (dB, max |diff|)."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    t0 = time.perf_counter()
    real = ms.extract_features_padded
    ms.extract_features_padded = (
        lambda *a, **k: real(*a, **k).flip(1).contiguous())
    try:
        z_rev = _filter_channel(img_d, idx_d, cfg,
                                plain=True)[0].cpu().numpy()
    finally:
        ms.extract_features_padded = real
    f_db = abs(gt.psnr(img, z_rev) - gt.psnr(img, z_plain))
    f_max = float(np.abs(z_rev - z_plain).max())
    phase("plain", f"{tag}: the plain path against itself with the feature "
          f"lanes reversed: {f_db:.6f} dB, max |diff| {f_max:.3e} (the f32 "
          f"floor)", t0)
    return f_db, f_max


def plain_bars(gt, cfg, img, img_d, idx_d, z_plain, tag, floor):
    """The kernel path's bars against the plain path: 0.02 dB and 2e-3,
    or with ``floor`` 1.5x the plain path's own f32 floor (f32_floor) where
    that is larger (the rule of the f64 slabs, 1.5x the plain version's
    error). Returns (dB bar, max bar, the floor or None)."""
    if not floor:
        return 0.02, 2e-3, None
    f = f32_floor(gt, cfg, img, img_d, idx_d, z_plain, tag)
    return max(0.02, 1.5 * f[0]), max(2e-3, 1.5 * f[1]), f


def bilateral_nlm_mv(gt, dev, rows, launches, info, patch=7):
    """Recipe C (make_workload_8mp_nlm_bilateral_matvec): the 8 MP matvec
    denoise with an NLM ``patch`` x ``patch`` patch (7, 9 or 11) and a
    spatial term, f32 tiles, 52, 84 or 124 live lanes of 64, 96 or 128:
    the coordinate K5/K6 twice a call through filter_image (their rows are
    recipe B's at the same patch), the kernel path against the plain path
    on the card, the quality rule (the reference loses PSNR too, 20.22 ->
    16.56, 16.54 and 16.52 dB at 7 x 7, 9 x 9 and 11 x 11 on 256 x 512,
    scripts/reference_quality.py --recipes C Cp9 Cp11; ROADMAP.md Queue 3:
    the PSNR is printed), and the recipe at 96x96 against the CPU."""
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.models.pipeline import _filter_channel
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    t0 = time.perf_counter()
    lanes, live = PATCH_LANES[patch], NLM_COORD_LIVE[patch]
    what = f"recipe C at {patch}x{patch}"
    cfg, img, noisy, plan = make_workload_8mp_nlm_bilateral_matvec(gt, patch)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    require(ctx.fa_aug is None and ctx.coords and ctx.live == live
            and ctx.f_t.shape[0] == lanes and cfg.filter_mode == "matvec",
            f"{what} did not reach the {lanes}-lane f32 coordinate layout")
    phase(nlm_key("bilateral-nlm-8mp-mv", patch, "-"),
          f"workload and layouts at {H8}x{W8} (p="
          f"{ctx.p}, {ctx.live} live lanes of {ctx.f_t.shape[0]}, h {cfg.h}, "
          f"{cfg.filter_name} {cfg.filter_mode}, sinkhorn_coarse "
          f"{cfg.sinkhorn_coarse}, polish {cfg.sinkhorn_polish})", t0)
    del ctx
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sfx = lanes_sfx(lanes)
    names = ("matvec_coord" + sfx, "rmatvec_coord" + sfx)
    counters = {names[0]: k56.matvec_cuda, names[1]: k56.rmatvec_cuda}
    res, walls, peak, counts = drive(gt, noisy, cfg, plan, dev, counters,
                                     nlm_key("bilateral-nlm-8mp-mv", patch,
                                             "-"))
    launches.update(counts)
    per_call = {k: v / RUNS for k, v in counts.items()}
    psnr_in, psnr_out = gt.psnr(img, noisy), gt.psnr(img, res.image)
    phase("e2e-8mp-mv", f"{what}: walls {[round(w, 6) for w in walls]} s "
          f"(min {min(walls):.6f}); peak memory {peak / 2**30:.3f} GiB; PSNR "
          f"{psnr_in:.3f} -> {psnr_out:.3f} dB (gain "
          f"{psnr_out - psnr_in:.3f}, not required: the recipe degenerates "
          f"in the reference too); launches per call {per_call}", t0)
    require(res.image.shape == (H8, W8) and np.isfinite(res.image).all(),
            f"{what} output is not a finite (2048, 4096) image")
    require(per_call == {names[0]: 2, names[1]: 2},
            f"{what} should launch K5 and K6 twice a call")

    t0 = time.perf_counter()
    z_plain = _filter_channel(img_d, idx_d, cfg, plain=True)[0].cpu().numpy()
    d_db = abs(psnr_out - gt.psnr(img, z_plain))
    d_max = float(np.abs(res.image - z_plain).max())
    b_db, b_max, floor = plain_bars(gt, cfg, img, img_d, idx_d, z_plain,
                                    what, True)
    phase("plain", f"{what} kernel path vs plain path on the card: "
          f"{d_db:.6f} dB, max |diff| {d_max:.3e} (bar {b_db:.4f} dB, "
          f"{b_max:.3e})", t0)
    require(d_db <= b_db and d_max <= b_max, f"{what} kernel path != plain")
    del img_d, idx_d, z_plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small = cfg.replace(sample_rho=0.05, block_cols=2048, sinkhorn_coarse=4,
                        gram_coarse=4)
    im_s, nz_s = noisy_image(gt, 96, 96)
    pl_s = gt.make_plan(nz_s, small)
    z_cpu = gt.filter_image(nz_s, small, plan=pl_s, device="cpu").image
    z_gpu = gt.filter_image(nz_s, small, plan=pl_s, device=dev).image
    s_db = abs(gt.psnr(im_s, z_cpu) - gt.psnr(im_s, z_gpu))
    s_max = float(np.abs(z_cpu - z_gpu).max())
    phase("small", f"96x96 {what}: card kernels vs CPU plain: {s_db:.6f} "
          f"dB, max |diff| {s_max:.3e} (bar 0.02 dB, 2e-3)", t0)
    require(np.isfinite(z_gpu).all() and s_db <= 0.02 and s_max <= 2e-3,
            f"96x96 {what} card run != CPU plain run")
    info[nlm_key("bilateral_nlm_8mp_mv", patch)] = dict(
        walls_s=walls, peak_bytes=peak, psnr_in=psnr_in, psnr_out=psnr_out,
        launches_per_call=per_call, plain_path_db=d_db, plain_path_max=d_max,
        plain_floor=floor, small_db=s_db, small_max=s_max)


def ptxas_lines(log: str):
    """nvcc's -Xptxas -v report as (kernel, line) pairs, the kernel named
    by the part of its mangled name after the anonymous namespace (its name
    and template arguments)."""
    name = "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+)", name)
            name = (m.group(1) if m else name)[:48]
        else:
            yield name, ln


def spill_lines(log: str) -> list:
    """"kernel: spill line" for every kernel that spills."""
    return [f"{name}: {ln.strip()}" for name, ln in ptxas_lines(log)
            if "spill" in ln and not ln.strip().startswith("0 bytes")]


def sass_uses(build, kernel: str, opcode: str) -> dict:
    """{function name: whether its SASS holds ``opcode``} for every function
    of the built kernel library whose name holds ``kernel``
    (cuobjdump -sass, beside nvcc)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.lib_path())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            out[name[name.index(kernel):][:40]] = opcode in fn
    return out


def main() -> None:
    # 1. device
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script runs only on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global EXP_RATE
    EXP_RATE = sms * MUFU_PER_CLOCK * clock_mhz * 1e6
    dev = torch.device("cuda", 0)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; {card}; "
          f"{sms} SMs, max SM clock {clock_mhz:.0f} MHz, exp rate "
          f"{EXP_RATE:.4e}/s")

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.ops import _build

    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ptxas.txt").write_text(_build.PTXAS_LOG)
    phase("build", f"{build_s:.1f} s; ptxas spill lines: "
          f"{spill_lines(_build.PTXAS_LOG)}")
    store = [ln.strip() for name, ln in ptxas_lines(_build.PTXAS_LOG)
             if "coord_store_kernel" in name and ("Used" in ln or "spill" in ln)]
    phase("build", f"K1's coordinate cross and the f32 K7 (coord_store_kernel, "
          f"one kernel at every lane count; K1's bf16 and f32 stores, K7's "
          f"scaled f32 entry), from -Xptxas -v: {store}")
    require(len([ln for ln in store if "Used" in ln]) == 3
            and not any("spill" in ln and not ln.startswith("0 bytes")
                        for ln in store),
            "the coordinate store kernel is missing an epilogue or spills")
    coord = [ln.strip() for name, ln in ptxas_lines(_build.PTXAS_LOG)
             if "coord_tile_kernel" in name and ("Used" in ln or "spill" in ln)]
    phase("build", f"coordinate K5/K6 (coord_tile_kernel, one kernel at every "
          f"lane count), from -Xptxas -v: {coord}")
    require(any("Used" in ln for ln in coord)
            and not any("spill" in ln and not ln.startswith("0 bytes")
                        for ln in coord),
            "the coordinate K5/K6 kernel is missing or spills")
    k8f = [ln.strip() for name, ln in ptxas_lines(_build.PTXAS_LOG)
           if "ext2_f32_tile_kernel" in name and ("Used" in ln or "spill" in ln)]
    resident = {fd: (_build.lib().glt_ext2_f32_clusters(4096, fd, 1 << 30),
                     4096 // (256 if fd == 128 else 512))
                for fd in (32, 64, 96, 128)}
    phase("build", f"f32 K8 (ext2_f32_tile_kernel<512> up to 96 lanes, <256> "
          f"at 128), from -Xptxas -v: {k8f}; resident clusters x blocks at "
          f"p_pad 4096 by depth: {resident}")
    require(len([ln for ln in k8f if "Used" in ln]) == 2
            and all(n > 0 for n, _ in resident.values()),
            "the f32 K8 kernel is missing or no cluster of it fits the card")
    hgmma = sass_uses(_build, "sandwich_kernel", "HGMMA")
    phase("build", f"K3/K4 kernels holding HGMMA (wgmma), from cuobjdump "
          f"-sass: {hgmma}")
    require(hgmma and all(hgmma.values()),
            "the K3/K4 sandwich kernels do not run on wgmma")
    hgmma = sass_uses(_build, "sandwich_split_kernel", "HGMMA")
    ffma_tile = sass_uses(_build, "sandwich_f32_kernel", "FFMA")
    phase("build", f"f32 K3/K4 kernels (three bf16 parts) holding HGMMA, "
          f"from cuobjdump -sass: {hgmma}; the FFMA tile's functions: "
          f"{ffma_tile}")
    require(len(hgmma) == 3 and all(hgmma.values()) and not ffma_tile,
            "the f32 K3/K4 do not run both phases on wgmma")
    hmma = sass_uses(_build, "affinity_kernel", "HMMA")
    phase("build", f"K1 emitter kernels holding HMMA (its split-fp16 cross "
          f"on the tensor cores), from cuobjdump -sass: {hmma}")
    require(hmma and all(hmma.values()),
            "the K1 emitter does not run its cross on the tensor cores")
    hmma = sass_uses(_build, "kb_emit_kernel", "HMMA")
    phase("build", f"K7 emitter holding HMMA (d2 on the tensor cores), from "
          f"cuobjdump -sass: {hmma}")
    require(hmma and all(hmma.values()),
            "the K7 emitter does not run d2 on the tensor cores")
    hmma = sass_uses(_build, "aug_sum_kernel", "HMMA")
    phase("build", f"aug K5/K6 kernels (32, 64, 96 and 128 lanes) holding "
          f"HMMA (d2 on the tensor cores), from cuobjdump -sass: {hmma}")
    require(len(hmma) == 4 and all(hmma.values()),
            "the aug K5/K6 kernels do not run their products on the tensor "
            "cores")
    hmma = sass_uses(_build, "f32_sum_kernel", "HMMA")
    phase("build", f"f32 K5/K6 kernels (32, 64, 96 and 128 lanes) holding "
          f"HMMA (the split-fp16 cross on the tensor cores), from cuobjdump "
          f"-sass: {hmma}")
    require(len(hmma) == 4 and all(hmma.values()),
            "the f32 K5/K6 kernels do not run their cross on the tensor "
            "cores")
    # K8, K9's ks pass and the V pass of K9/K10, every instantiation (32,
    # 64, 96 and 128 lanes; K8 at each P, the V pass at each width)
    for kernel, what in (("ext2_matvec_kernel", "K8"),
                         ("ks_kernel", "K9's ks pass"),
                         ("colstats_v_kernel", "the K9/K10 V pass")):
        hmma = sass_uses(_build, kernel, "HMMA")
        phase("build", f"{what}: {sum(hmma.values())} of {len(hmma)} "
              f"instantiations hold HMMA (cuobjdump -sass)")
        require(len(hmma) >= (32 if kernel == "ext2_matvec_kernel" else
                              16 if kernel == "colstats_v_kernel" else 4)
                and all(hmma.values()),
                f"{what}: an instantiation does not run on the tensor cores")

    hmma = sass_uses(_build, "colstats_tc_kernel", "HMMA")
    ffma_v = {**sass_uses(_build, "colstats_f32_kernel", "FFMA"),
              **sass_uses(_build, "ks_f32_kernel", "FFMA")}
    phase("build", f"f32 K9/K10: {sum(hmma.values())} of {len(hmma)} "
          f"instantiations (4, 32, 64, 96, 128 lanes; K9 and K10) hold HMMA "
          f"(V and ks on the tensor cores), from cuobjdump -sass; the FFMA "
          f"V and ks passes' functions: {ffma_v}")
    require(len(hmma) == 10 and all(hmma.values()) and not ffma_v,
            "the f32 K9/K10 do not run V and ks on the tensor cores in one "
            "launch")

    rows, launches, info = {}, {}, {}
    config2(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    config2_f32(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    config1_fast(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    for patch in (7, 9, 11):
        config2_patch(gt, dev, rows, launches, info, patch)
        torch.cuda.empty_cache()
    config4(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    for patch in (7, 9, 11):
        config4(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
        config4t(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
    for patch in (5, 7, 9, 11):
        config3(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
    for patch in (5, 7, 9, 11):
        config4q(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
    config4t(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    staged(gt, dev, info)
    torch.cuda.empty_cache()
    dense(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    bilateral(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    for patch in (7, 9, 11):
        config1_fast(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
    cli_phase(gt, dev, rows, launches, info)
    torch.cuda.empty_cache()
    for patch in (7, 9, 11):
        bilateral(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()
        bilateral_nlm_mv(gt, dev, rows, launches, info, patch=patch)
        torch.cuda.empty_cache()

    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"]) for name in NAMES]
    total_s = time.perf_counter() - t_all
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, sm_clock_max_mhz=clock_mhz, exp_rate=EXP_RATE,
        build_s=build_s, total_s=total_s, kernels=kernels,
        rows=rows, runs_per_count=RUNS, torch=torch.__version__, **info),
        indent=1))
    phase("done", f"all phases passed in {total_s:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
