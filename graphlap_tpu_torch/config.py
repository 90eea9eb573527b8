"""Pipeline configuration — a verbatim copy of ``graphlap_tpu/config.py``.

The port keeps the reference's configuration object field for field, so a
config crosses between the packages as ``PipelineConfig(**cfg.to_dict())``
with an equal ``config_hash()`` (tests/test_torch_config.py pins the two
copies equal for every preset level). Every measured claim in the comments
below was taken on the reference's TPU, not on the port's GPU. Edit only
together with the original.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass


KERNELS = ("gaussian", "nlm")
NORMALIZATIONS = ("sinkhorn", "symmetric", "none")
FILTERS = ("identity", "power", "lowpass", "sharpen", "exp_decay", "twicing")
# Filters applied in AFFINE form, z = y + V (f(L) - 1) V^T y (ops/filters.py
# registry `affine=True`; kept in sync by tests/test_presets.py). In
# SPECTRAL mode these weight the kept basis by f(lambda)-1 ~ beta instead
# of damping it by lambda ~ 0, and kernel spectra collapse into
# near-degenerate clusters past the first few eigenvalues (measured gaps
# ~1e-5 at the m=50 boundary) — so the rank-m affine output rides an
# ill-posed subspace selection: EVERY accelerated recipe measured 1.8-4.6
# dB off the exact trajectory at cfg3, with polish/coarse depth irrelevant
# (benchmarks/results/cfg3_sweep.jsonl). Presets route SHARPEN to
# filter_mode="matvec" (exact polynomial application by strip matvecs, no
# eigensolve — see MATVEC_FILTERS); TWICING deliberately stays spectral:
# the low-rank polynomial's f(0)=0 kills the out-of-rank residual whose
# add-back is twicing's point (tuned_config routing note).
AFFINE_FILTERS = ("sharpen", "twicing")
# Polynomial-in-W filters admitting exact matvec application — a
# dependency-free copy of ops/filters.MATVEC_FILTERS (config stays pure
# Python); tests/test_presets.py pins the two together.
MATVEC_FILTERS = ("identity", "power", "sharpen", "twicing")
# lambda-function filters a Chebyshev series can fit (everything except
# the index-set 'lowpass' projection) — copy of ops/filters.
CHEBYSHEV_FILTERS = ("identity", "power", "sharpen", "exp_decay", "twicing")
FILTER_MODES = ("spectral", "matvec", "chebyshev")
SOLVERS = ("oneshot", "chol", "lobpcg", "sketch")
DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class PipelineConfig:
    """All knobs of the global graph-Laplacian filter pipeline.

    Mirrors the reference CLI flags (image path aside): kernel type,
    bandwidth h, sample fraction, #eigenpairs, filter type
    (SURVEY.md §2.2 component #1).
    """

    # --- affinity kernel ---
    kernel: str = "gaussian"       # "gaussian" (photometric) | "nlm" (patch)
    h: float = 0.15                # photometric bandwidth, image range [0,1]
    spatial_h: float = 0.0         # >0: bilateral spatial term, bandwidth in px
    patch_size: int = 5            # NLM patch side (config 2: 5x5)

    # --- Nystrom sampling ---
    sample_rho: float = 0.01       # target sample fraction of N
    sample_cap: int = 8192         # hard cap on p (SURVEY.md §1.3 scaling note)
    sample_mode: str = "grid"      # "grid" (reference's spatially uniform
                                   # every-k-th-pixel strategy) | "random"
                                   # (uniform random subset, the GLIDE
                                   # papers' variant; seeded, host-side)
    sample_seed: int = 0           # RNG seed for sample_mode="random"

    # --- normalization ---
    normalization: str = "sinkhorn"  # "sinkhorn" | "symmetric" | "none"
    sinkhorn_iters: int = 20         # fixed (shape-static) iteration count
    sinkhorn_coarse: int = 1         # >1 runs the Sinkhorn fixed point
                                     # against every k-th column (PAPERS.md
                                     # scalable-Sinkhorn idea) + one
                                     # full-res extension pass; honored by
                                     # BOTH the streaming and dense paths
    sinkhorn_polish: int = 0         # with sinkhorn_coarse only:
                                     # after the decimated fixed point,
                                     # run this many FULL-resolution
                                     # symmetric iterations — each one
                                     # contracts the decimation bias toward
                                     # the exact fixed point at ~2 strip
                                     # passes apiece (coarse k=16 alone is
                                     # ~0.1 dB off the exact trajectory at
                                     # 8 MP; polish pulls it back under the
                                     # gate at a fraction of full-res cost)
    sinkhorn_sample: str = "auto"    # coarse-Sinkhorn column sample on the
                                     # STREAMING paths. "diag" rotates the
                                     # in-slot offset by a k-coprime step
                                     # per image row; "stride" is the
                                     # plain ::k. MEASURED split (both
                                     # 4-seed sweeps vs per-seed f32-exact
                                     # trajectories): diag wins on the
                                     # strip_cache path (cfg2: 0.011-0.028
                                     # vs stride's 0.031-0.094 dB — the
                                     # natural-order raster alias) but
                                     # LOSES on the recompute path (cfg4:
                                     # 0.064-0.077 vs stride's
                                     # 0.0007-0.0063 dB; ss_* rows in
                                     # cfg4_sweep.jsonl). "auto" (default)
                                     # resolves diag iff strip_cache —
                                     # exactly the measured split. The
                                     # dense path always strides (permuted
                                     # [A;B] columns are already
                                     # raster-decorrelated).
    gram_jitter_seed: int = 0        # seed of the jittered coarse-gram
                                     # column sample (models/streaming.
                                     # gram_sample_idx, active at
                                     # gram_coarse >= 16). Cross-seed
                                     # spread at 8 MP is measured in
                                     # cfg4_sweep.jsonl (jseed_* rows);
                                     # exposed so deployments can re-draw
                                     # if an image aligns badly with one
                                     # draw
    gram_coarse: int = 1             # streaming only: >1 estimates the
                                     # O(Np^2) one-shot cross W_AB W_AB^T
                                     # (the single-chip cost king: 2.18 s of
                                     # cfg4's 3.24 s, benchmarks/results/
                                     # profile.jsonl) from every k-th column,
                                     # energy-ratio rescaled. Kernel columns
                                     # of adjacent pixels are near-duplicates,
                                     # so spatial decimation is the same
                                     # Monte-Carlo trick as sinkhorn_coarse;
                                     # error shrinks with N (tests pin it)

    # --- eigensolve ---
    num_eigvecs: int = 50          # m, kept eigenpairs
    eig_tol: float = 3e-3         # relative spectral cutoff / ridge scale
    lobpcg_iters: int = 60         # LOBPCG iteration cap (converges ~17-25
                                   # on kernel spectra; headroom for tails)
    solver: str = "lobpcg"         # "chol" (1x eigh + Cholesky ridge: TPU-fast,
                                   #   backward-stable, exactly orthonormal V) |
                                   # "lobpcg" (DEFAULT: chol + top-m iterative
                                   #   solve, O(p^2 m); falls back to the dense
                                   #   eigh when 5m >= p, so small problems are
                                   #   bit-identical to "chol") |
                                   # "sketch" (randomized subspace iteration:
                                   #   never forms the O(p^2 N) gram — thin
                                   #   strip passes only; the dense fast-preset
                                   #   solver, see ops/nystrom.py) |
                                   # "oneshot" (classical Fowlkes one-shot:
                                   #   3x eigh, truncated pinv)
    sketch_oversample: int = 78    # sketch block k = m + oversample (128-lane
                                   #   aligned at the default m=50)
    sketch_power: int = 2          # subspace (power) iterations

    # --- spectral filter ---
    filter_name: str = "identity"  # see ops/filters.py registry
    filter_param: float = 1.0      # k for power, beta for sharpen, tau for exp
    filter_mode: str = "spectral"  # "spectral": f(L) through the rank-m
                                   # Nystrom eigenbasis (the reference form;
                                   # required for 'lowpass' and for basis
                                   # reuse/checkpointing) |
                                   # "matvec": EXACT f(W) y by repeated strip
                                   # matvecs for polynomial filters
                                   # (MATVEC_FILTERS) — skips the gram +
                                   # eigensolve entirely and is immune to
                                   # the near-degenerate-cluster subspace
                                   # instability that makes rank-m AFFINE
                                   # filters ill-posed (AFFINE_FILTERS note) |
                                   # "chebyshev": degree-cheb_degree series
                                   # of f applied by the three-term matvec
                                   # recurrence (Hammond et al. 2011) —
                                   # the eigensolve-free path for
                                   # NON-polynomial f (exp_decay, fractional
                                   # power). NB twicing in ANY operator mode
                                   # (matvec or chebyshev) kills the
                                   # out-of-rank residual whose add-back is
                                   # its point — see the tuned_config
                                   # routing note; spectral is the useful
                                   # twicing form
    cheb_degree: int = 12          # chebyshev mode: series degree = number
                                   # of strip matvecs (12 reaches ~1e-6
                                   # relative error on exp_decay tau<=4;
                                   # cost scales linearly). 0 = AUTO:
                                   # smallest degree whose series tail
                                   # bounds the sup-norm error <= 1e-6
                                   # (filters.chebyshev_auto_degree —
                                   # exact polynomials resolve to their
                                   # true degree; non-smooth f clamps
                                   # at 64, set an explicit degree there)

    # --- color handling ---
    rgb_mode: str = "per_channel"  # "per_channel" (reference behavior:
                                   # C independent pipelines) |
                                   # "luma_basis" (guided-filter variant:
                                   # ONE eigenbasis from the BT.601
                                   # luminance graph applied to every
                                   # channel — ~C x cheaper, since the
                                   # affinity/Sinkhorn/eigensolve stages
                                   # run once and the per-channel work is
                                   # just the O(N m) filter apply)

    # --- precision policy ---
    affinity_dtype: str = "float32"  # K-strip precision:
                                     # "float32" — exact;
                                     # "bfloat16" — bf16 distance-GEMM
                                     #   inputs (fast, but the GEMM-trick
                                     #   cancellation costs 0.135 dB at
                                     #   cfg2 — cfg2_sweep.jsonl);
                                     # "bfloat16_store" — f32 distances/
                                     #   exp, strip STORED bf16: halves all
                                     #   downstream strip bandwidth (the
                                     #   Sinkhorn wall) with only output
                                     #   rounding. Dense path only —
                                     #   streaming recomputes tiles, so
                                     #   storage dtype is moot there
                                     #   (treated as float32)
    gram_dtype: str = "auto"         # dense path: dtype of the one-shot
                                     # cross GEMM W_AB W_AB^T only ("auto"
                                     # follows affinity_dtype). bf16 here is
                                     # the cheapest large win at 512^2-class
                                     # sizes: the cross is the eigensolve
                                     # stage's dominant cost and its input
                                     # rounding only perturbs the p x p
                                     # spectrum (parity measured in
                                     # benchmarks/results/). Streaming paths
                                     # ignore it (tile dtype rules there)
    feature_dtype: str = "float32"   # storage dtype of the (N, d) feature
                                     # tensor — the capacity ceiling of the
                                     # STREAMING path (tiles are recomputed;
                                     # features are the only O(N)-by-d
                                     # buffer). "bfloat16" halves it,
                                     # raising single-chip capacity ~2x.
                                     # Pair with a bf16 tile mode: there the
                                     # GEMM inputs are rounded to bf16
                                     # anyway, so the only ADDITIONAL error
                                     # is in the f32 feature norms
                                     # (measured — see BASELINE/STATUS).
                                     # Requires spatial_h == 0: bf16 has 8
                                     # mantissa bits, and large absolute
                                     # pixel coordinates lose the
                                     # neighbor-distance cancellation
                                     # (validated at config time)
    use_pallas: bool = False         # fused Pallas affinity kernel
    streaming: bool = False          # recompute K tiles blockwise (big images)
    strip_cache: bool = False        # streaming=True only: materialize the
                                     # (p, n_pad) kernel strip ONCE (natural
                                     # pixel order, padding columns exactly
                                     # zero) and run every strip product as
                                     # a GEMM against it instead of
                                     # recomputing tiles. The dense-capacity
                                     # twin of the streaming model: same
                                     # masks, same estimator, NO [A; B]
                                     # permutation (the dense path's N-row
                                     # feature gather measured ~20 ms of
                                     # cfg2's 34 ms affinity stage). Caller
                                     # must keep p*n_pad*itemsize within
                                     # HBM (trace-time check). Incompatible
                                     # with fused_finish (that fusion exists
                                     # to avoid recompute, which strip_cache
                                     # already avoids); uniquely ALLOWS
                                     # solver='sketch' on the streaming
                                     # entry points (thin passes against
                                     # the materialized strip)
    block_cols: int = 65536          # streaming column-block width
    fused_finish: bool = False       # streaming + Pallas: fuse the FOUR
                                     # full-resolution finishing sweeps of
                                     # the coarse-Sinkhorn factor (the
                                     # extension rmatvec2, the polish
                                     # matvec, the polish rmatvec, the
                                     # colstats+V pass — each an O(Np)
                                     # exp-bound kernel recompute) into
                                     # TWO Pallas passes whose kb tile
                                     # serves both consumers from VMEM
                                     # (ops/pallas_streaming
                                     # ext2_matvec_pallas /
                                     # finish_colstats_pallas). The p x p
                                     # spectrum takes POST-polish scales
                                     # from a 1/gram_coarse-cost
                                     # decimated rmatvec between the
                                     # sweeps (basis0 must exist before
                                     # the last sweep) — the same
                                     # estimator the unfused gc recipe
                                     # runs; parity + wall A/B in
                                     # cfg4_sweep.jsonl ffin_*/ffin2_*.
                                     # Requires streaming + use_pallas +
                                     # sinkhorn_coarse>1 + gram_coarse>1 +
                                     # sinkhorn_polish==1 (validated);
                                     # falls back to the unfused sweeps on
                                     # shape gates (p_pad > 4096, m > 128,
                                     # or the M_PAD-wide V buffer over
                                     # _V_BYTES_CAP)

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {self.kernel!r}")
        if self.normalization not in NORMALIZATIONS:
            raise ValueError(
                f"normalization must be one of {NORMALIZATIONS}, got {self.normalization!r}"
            )
        if self.filter_name not in FILTERS:
            raise ValueError(f"filter_name must be one of {FILTERS}, got {self.filter_name!r}")
        if self.filter_mode not in FILTER_MODES:
            raise ValueError(f"filter_mode must be one of {FILTER_MODES}, "
                             f"got {self.filter_mode!r}")
        if self.filter_mode == "matvec":
            if self.filter_name not in MATVEC_FILTERS:
                raise ValueError(
                    f"filter_mode='matvec' supports polynomial filters "
                    f"{MATVEC_FILTERS}, got {self.filter_name!r}")
            if (self.filter_name in ("power", "twicing")
                    and (self.filter_param != int(self.filter_param)
                         or self.filter_param < 1)):
                raise ValueError(
                    f"filter_mode='matvec' needs an integer filter_param >= 1 "
                    f"for {self.filter_name!r} (fractional 'power' can use "
                    f"filter_mode='chebyshev'), got {self.filter_param!r}")
        if self.filter_mode == "chebyshev":
            if self.filter_name not in CHEBYSHEV_FILTERS:
                raise ValueError(
                    f"filter_mode='chebyshev' needs a lambda-function filter "
                    f"{CHEBYSHEV_FILTERS}, got {self.filter_name!r}")
            if (self.filter_name in ("power", "twicing")
                    and self.filter_param < 0):
                # mirror ops/filters.check_chebyshev_filter — config-time
                # and apply-time validation are pinned equal by
                # tests/test_filters.py::test_config_and_ops_validation_agree
                raise ValueError(
                    f"{self.filter_name!r} needs filter_param >= 0, got "
                    f"{self.filter_param!r}")
            if self.cheb_degree < 0:
                raise ValueError("cheb_degree must be >= 1, or 0 for auto")
            if self.normalization == "none":
                # the series is fit on [-1, 1]; the RAW kernel completion's
                # spectral radius is the max row sum (~1e3-1e4 at MP sizes),
                # and T_k grows like (2 rho)^k outside the interval — the
                # recurrence overflows f32 by degree ~12 and returns NaNs
                raise ValueError(
                    "filter_mode='chebyshev' requires a normalized operator "
                    "(spec(W) in [-1, 1]): use normalization='sinkhorn' or "
                    "'symmetric', not 'none'")
        if self.affinity_dtype not in DTYPES + ("bfloat16_store",):
            raise ValueError(f"affinity_dtype must be one of "
                             f"{DTYPES + ('bfloat16_store',)}")
        if self.feature_dtype not in DTYPES:
            raise ValueError(f"feature_dtype must be one of {DTYPES}")
        if self.feature_dtype == "bfloat16" and self.spatial_h > 0.0:
            raise ValueError(
                "feature_dtype='bfloat16' cannot carry spatial coordinates: "
                "bf16's 8 mantissa bits lose the neighbor-distance "
                "cancellation for large absolute (row, col) values — use "
                "feature_dtype='float32' with spatial_h > 0")
        if self.affinity_dtype == "bfloat16" and self.spatial_h > 0.0:
            # same cancellation, different entry point: the bf16 GEMM-trick
            # cross against f32 norms is catastrophic for coordinate
            # features (verified: adjacent 8 MP pixels, true d2=0.026 ->
            # bf16-cross d2=87.6, K collapses 0.975 -> 1e-38). 'bfloat16_
            # store' stays valid: it computes distances/exp in f32 and
            # only STORES the result rounded.
            raise ValueError(
                "affinity_dtype='bfloat16' (bf16 GEMM inputs) cannot carry "
                "spatial coordinates — the distance cancellation fails "
                "catastrophically at image-scale (row, col) magnitudes. "
                "Use 'float32' or 'bfloat16_store' with spatial_h > 0")
        if self.gram_dtype not in DTYPES + ("auto",):
            raise ValueError(f"gram_dtype must be 'auto' or one of {DTYPES}")
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {self.solver!r}")
        if self.patch_size % 2 != 1:
            raise ValueError("patch_size must be odd")
        if not (0.0 < self.sample_rho <= 1.0):
            raise ValueError("sample_rho must be in (0, 1]")
        if self.sample_mode not in ("grid", "random"):
            raise ValueError(f"sample_mode must be 'grid' or 'random', "
                             f"got {self.sample_mode!r}")
        if self.rgb_mode not in ("per_channel", "luma_basis"):
            raise ValueError(f"rgb_mode must be 'per_channel' or "
                             f"'luma_basis', got {self.rgb_mode!r}")
        if self.sinkhorn_sample not in ("auto", "diag", "stride"):
            raise ValueError(f"sinkhorn_sample must be 'auto', 'diag' or "
                             f"'stride', got {self.sinkhorn_sample!r}")
        if self.sinkhorn_iters < 1:
            # iters=0 is sane for the full-res loop (s=1, raw kernel) but
            # the COARSE fixed point would divide by its zeroed carries
            # and emit ~3e14 scales (review finding) — reject uniformly
            raise ValueError("sinkhorn_iters must be >= 1 (use "
                             "normalization='none' for the raw kernel)")
        if self.strip_cache and not self.streaming:
            raise ValueError(
                "strip_cache materializes the STREAMING model's strip — "
                "set streaming=True (the classic dense path has its own "
                "[A; B] strip already)")
        if self.strip_cache and self.fused_finish:
            raise ValueError(
                "strip_cache and fused_finish are mutually exclusive: the "
                "fused finish exists to avoid tile recomputes, which "
                "strip_cache already avoids by materializing the strip")
        if self.streaming and self.solver == "sketch" and not self.strip_cache:
            # the randomized sketch needs a materialized strip for its thin
            # passes; the recompute streaming eigensolve would silently
            # fall back to the slow one-shot formulation with a mismatched
            # K_AA regularization (review finding). strip_cache provides
            # exactly that strip, so it lifts the restriction.
            raise ValueError(
                "solver='sketch' needs a materialized strip — use the "
                "dense path, or streaming with strip_cache=True; recompute "
                "streaming configs use solver='lobpcg' (default) or 'chol'")
        if self.sinkhorn_coarse < 1:
            raise ValueError("sinkhorn_coarse must be >= 1")
        if self.gram_coarse < 1:
            raise ValueError("gram_coarse must be >= 1")
        if self.sinkhorn_polish < 0:
            raise ValueError("sinkhorn_polish must be >= 0")
        if self.lobpcg_iters < 1:
            raise ValueError("lobpcg_iters must be >= 1")
        if self.sketch_oversample < 0:
            raise ValueError("sketch_oversample must be >= 0")
        if self.sketch_power < 0:
            raise ValueError("sketch_power must be >= 0")
        if self.fused_finish:
            if not (self.streaming and self.use_pallas):
                raise ValueError(
                    "fused_finish fuses the STREAMING path's Pallas "
                    "sweeps — it requires streaming=True and "
                    "use_pallas=True")
            if (self.normalization != "sinkhorn" or self.sinkhorn_coarse <= 1
                    or self.sinkhorn_polish != 1):
                raise ValueError(
                    "fused_finish fuses the coarse-Sinkhorn finishing "
                    "sweeps: it requires normalization='sinkhorn', "
                    "sinkhorn_coarse > 1 and sinkhorn_polish == 1")
            if self.gram_coarse <= 1:
                raise ValueError(
                    "fused_finish needs gram_coarse > 1: its p x p "
                    "spectrum takes post-polish scales from a decimated "
                    "rmatvec at the gram-sample columns (a full-column "
                    "gram would need the full-res polish the fused "
                    "schedule is avoiding)")

    def operator_filter(self) -> bool:
        """True for the eigensolve-free application modes (matvec exact
        polynomial / chebyshev series) — the pipelines branch on this."""
        return self.filter_mode in ("matvec", "chebyshev")

    def gram_gemm_dtype(self) -> str:
        """Resolved dtype of the dense one-shot cross GEMM."""
        if self.gram_dtype != "auto":
            return self.gram_dtype
        # bfloat16_store already holds the strip in bf16 — the native bf16
        # MXU pass is both the fast and the bandwidth-matched choice
        return ("bfloat16"
                if self.affinity_dtype in ("bfloat16", "bfloat16_store")
                else "float32")

    def resolved_sinkhorn_sample(self) -> str:
        """'diag' or 'stride' — the coarse-Sinkhorn sample the streaming
        paths actually use. 'auto' encodes the measured split: diagonal on
        the strip_cache path (where the plain stride raster-aliases, cfg2
        scfold rows), stride on the recompute path (where the diagonal
        measures a consistent ~0.07 dB WORSE, cfg4 ss_* rows)."""
        if self.sinkhorn_sample != "auto":
            return self.sinkhorn_sample
        return "diag" if self.strip_cache else "stride"

    def num_samples(self, n_pixels: int) -> int:
        """p = min(cap, ceil(rho * N)), at least num_eigvecs."""
        p = min(self.sample_cap, math.ceil(self.sample_rho * n_pixels))
        p = max(p, self.num_eigvecs)
        return min(p, n_pixels)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def config_hash(self) -> str:
        """Stable hash recorded in run logs (SURVEY.md §5)."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _pow2_at_most(x: int) -> int:
    """Largest power of two <= x (1 if x < 1)."""
    return 1 if x < 1 else 1 << (x.bit_length() - 1)


def _pow2_divisor(x: int) -> int:
    """Largest power of two DIVIDING x (x >= 1)."""
    return x & -x


def calibrated_gram_coarse(n_pixels: int, p: int, gate: bool = True,
                           max_k: int = 64) -> int:
    """Largest seed-robust gram decimation factor for this problem size.

    Two measured regimes (docs/ARCHITECTURE.md §5, cfg4_sweep.jsonl):
    JITTERED sampling (models/streaming.gram_sample_idx, k >= 16) holds a
    flat <=0.066 dB cross-seed parity down to N/k_g >= 32 p retained
    columns (gc64 at 8 MP/p=4096 = the 32 p boundary: 0.031-0.054 dB
    across seeds; gc32: 0.046-0.064); STRIDED sampling (k <= 8) is
    alias-limited and needs N/k_g >= 256 p. Below the jittered regime
    (N < 512 p) the strided rule can never clear k = 2 (N/256p < 2), so
    the gate path simply disables decimation there. Turbo (gate=False)
    relaxes the jittered floor to 16 p; both cap at the measured k = 64.

    ``max_k`` caps the factor (presets pass the largest power of two
    dividing block_cols so the result always satisfies the streaming
    path's divisibility requirement). When the cap forces the gate path
    below the jittered floor of 16, it falls back to the alias-limited
    STRIDED rule (needs 256 columns per retained sample) instead of the
    jittered one, preserving the measured parity contract.
    """
    cap = min(64, _pow2_at_most(max_k))
    if not gate:
        return max(1, min(_pow2_at_most(n_pixels // (16 * p)), cap))
    k = min(_pow2_at_most(n_pixels // (32 * p)), cap)
    if k >= 16:
        return k
    # jittered regime unreachable (small N, or a block_cols cap below 16):
    # the strided estimator is safe only at >=256 columns per sample
    return max(1, min(_pow2_at_most(n_pixels // (256 * p)), cap))


def calibrated_sinkhorn_coarse(n_pixels: int, p: int, max_k: int = 64) -> int:
    """Largest Sinkhorn decimation factor assuming one full-res polish.

    The decimated fixed point needs ~32 columns per sample (headline recipe:
    sc64 at 8 MP keeps N/k_s = 32 p) — the residual scaling bias is then
    contracted under the gate by ONE full-resolution polish iteration
    (cfg4_sweep.jsonl: 0.007-0.053 dB across seeds). Without polish the same
    factor measures ~0.3 dB; callers must pair k_s > 1 with polish >= 1 for
    parity-grade output. ``max_k`` caps the factor (presets pass the
    largest power of two dividing block_cols — divisibility contract).
    """
    cap = min(64, _pow2_at_most(max_k))
    return max(1, min(_pow2_at_most(n_pixels // (32 * p)), cap))


def tuned_config(cfg: PipelineConfig, n_pixels: int, level: str = "fast",
                 keep: frozenset | set = frozenset()) -> PipelineConfig:
    """Apply a measured-recipe preset to ``cfg`` for an ``n_pixels`` image.

    Encodes the benchmark-tuned recipes (BASELINE.md measured table) so
    users get headline performance without hand-picking precision and
    decimation knobs:

    * ``"exact"`` — the all-f32 reference recipe (parity baseline): clears
      every accelerator.
    * ``"fast"`` — gate-compliant production recipe: dense path =
      bfloat16_store strip + Pallas + 8-iteration Sinkhorn
      (cfg2: 0.92 -> 0.29 s device at 0.0003-0.016 dB across 4 noise
      seeds); streaming path = bf16
      tiles + Pallas + calibrated decimations with one full-res polish
      (cfg4: 17.0 -> 0.47 s device at 8 MP, 0.031-0.054 dB seed-swept).
      NB the dense path deliberately avoids plain "bfloat16" (its
      GEMM-trick cancellation measured 0.135 dB at cfg2); STREAMING bf16
      tiles are a different numeric path and measure 0.0014 dB at the
      384^2 oracle anchor and 0.0025 dB at 8 MP
      (benchmarks/results/parity_anchor.jsonl, cfg4_sweep.jsonl).
    * ``"turbo"`` — max single-chip speed: streaming drops the polish and
      relaxes gram decimation (documented ~0.3 dB from the exact
      trajectory); dense drops Sinkhorn to 6 iterations (0.0026-0.051 dB,
      still gate-compliant).

    Decimation factors are auto-calibrated from (N, p) by the cross-seed
    rules above, so small images degrade gracefully to no decimation
    instead of inheriting 8 MP-tuned constants. Fields named in ``keep``
    are left untouched (CLI: flags the user set explicitly).
    """
    if level not in ("exact", "fast", "turbo"):
        raise ValueError(f"preset level must be exact|fast|turbo, got {level!r}")
    p = cfg.num_samples(n_pixels)
    if level == "exact":
        # restore a CONVERGED full-res Sinkhorn too (10 iters measured
        # converged, benchmarks/run.py _parity_cfg) — a fast config carries
        # iters=6 tuned for its coarse loop, which would leave "exact"
        # under-converged vs the parity contract
        chosen = dict(affinity_dtype="float32", gram_dtype="auto",
                      use_pallas=False, sinkhorn_coarse=1, sinkhorn_polish=0,
                      gram_coarse=1, fused_finish=False,
                      sinkhorn_iters=max(cfg.sinkhorn_iters, 10))
    elif cfg.streaming:
        # decimation factors must divide the ACTIVE column-block width,
        # which is min(block_cols, N) — an image smaller than block_cols
        # runs as one N-wide block (models/streaming._strip_ctx) — so cap
        # them at that width's largest power-of-two divisor; a preset can
        # then never produce a config the streaming path rejects
        kb = _pow2_divisor(min(cfg.block_cols, n_pixels))
        # bilateral (spatial_h > 0) configs must keep f32 GEMM inputs:
        # bf16 tiles catastrophically cancel on coordinate features
        # (__post_init__ guard above) — the preset loses the bf16 tile
        # speedup there rather than the output
        tile_dtype = "bfloat16" if cfg.spatial_h == 0.0 else "float32"
        chosen = dict(affinity_dtype=tile_dtype, use_pallas=True,
                      fused_finish=False,
                      gram_coarse=calibrated_gram_coarse(
                          n_pixels, p, gate=(level == "fast"), max_k=kb))
        # Capacity scale: past 16 MP the (N, d) feature tensor is the
        # streaming path's HBM ceiling (3.4 GB f32 at 32 MP for NLM 5x5);
        # storing it bf16 halves that for ~2x larger single-chip images.
        # Cost on the bf16-tile recipe this preset already chose is just
        # the f32 norm rounding: measured 0.0005 dB vs the float64 oracle
        # at 384^2 (parity_anchor.jsonl bf16_feat_bf16) and 0.0045/0.0099
        # dB vs the f32-feature twin at 256^2/96^2 (test_affinity pins).
        # spatial_h > 0 must keep f32 features (config-time invariant:
        # bf16 coordinates lose the neighbor-distance cancellation).
        if n_pixels >= 1 << 24 and cfg.spatial_h == 0.0:
            chosen["feature_dtype"] = "bfloat16"
        k_s = calibrated_sinkhorn_coarse(n_pixels, p, max_k=kb)
        if k_s > 1:
            pol = 1 if level == "fast" else 0
            if (level == "fast" and cfg.operator_filter()
                    and cfg.filter_name in ("identity", "power")):
                # sharp-kernel matvec denoise route (denoise_tuned h = sigma):
                # the Sinkhorn scales AND the tile values enter the OUTPUT
                # directly (z = diag(s) K diag(s) y — no rank-m projection
                # to absorb error), and the r5 cross-draw sweep (4 noise
                # seeds x 2 images, cfg4q_parity.jsonl jseed_*) killed the
                # bf16-tile recipes here: pol2 measures up to 0.18 dB and
                # pol3 up to 0.1175 dB vs the per-draw f32 full-res twin
                # on the LOW-NOISE draws (realized std 0.0959 vs 0.0976 —
                # the 1.8 dB-higher-quality regime where tile error shows).
                # Worst-draw controls isolate the tiles, not the coarse
                # Sinkhorn: f32 features + same coarse recipe 0.002 dB;
                # bf16 + FULL-res Sinkhorn still 0.104 dB — polish depth
                # cannot contract tile precision. So this branch routes to
                # f32 features/tiles (Pallas plain-f32 layout) + pol1:
                # worst-draw 0.0058 dB at 1.88 s / 4.5 MP/s at 8 MP
                # (bad_*/f32pallas_* rows). The sharpen matvec route keeps
                # bf16 + pol=1 (0.0008 dB measured at its wider h —
                # cfg3_sweep.jsonl; sharpen is excluded from this branch).
                chosen.update(affinity_dtype="float32",
                              feature_dtype="float32")
            chosen.update(sinkhorn_coarse=k_s, sinkhorn_iters=6,
                          sinkhorn_polish=pol)
        else:
            chosen.update(sinkhorn_coarse=1, sinkhorn_polish=0,
                          sinkhorn_iters=min(cfg.sinkhorn_iters, 10))
    else:
        # dense path: bfloat16_store is the measured dtype optimum for both
        # levels (decimations are streaming-only operators); they differ only
        # in Sinkhorn depth. 8 iterations measure 0.0003-0.016 dB vs the
        # converged f32 reference across 4 noise seeds for a ~6% device win
        # over 10 (cfg2 0.313 -> 0.294 s); turbo's 6 iterations measure
        # 0.0026-0.051 dB (2x under the gate) for another ~8%
        # (benchmarks/results/cfg2_sweep.jsonl bf16_store_iters{8,6}* rows).
        chosen = dict(affinity_dtype="bfloat16_store", use_pallas=True,
                      fused_finish=False,     # a streaming-path operator
                      sinkhorn_iters=min(cfg.sinkhorn_iters,
                                         8 if level == "fast" else 6))
        # Dense coarse Sinkhorn (+ one full-res polish): the alternating
        # fixed point against a strided 1/16 column slice of the strip.
        # Measured at cfg2: device 0.194 -> 0.148 s at 0.0006-0.044 dB
        # across 4 noise seeds (cfg2_sweep.jsonl dsc16_p1* rows; k=32 is
        # no faster — the extension + polish passes dominate — and spreads
        # worse). The CPU calibration at 128-256^2 shows thinner margins
        # (0.01-0.07 dB, dsc_calib) at small strips, so gate on the strip
        # width: fast needs nb >= 128k columns, turbo >= 64k.
        nb = n_pixels - p
        nb_floor = 131072 if level == "fast" else 65536
        if nb >= nb_floor:
            # matvec denoise route: same direct s-sensitivity as the
            # streaming branch (cfg4q_parity.jsonl) — one extra polish
            pol = (2 if (level == "fast" and cfg.operator_filter()
                         and cfg.filter_name in ("identity", "power"))
                   else 1)
            chosen.update(sinkhorn_coarse=16, sinkhorn_polish=pol)
        # Eigensolver: the randomized sketch replaces the cross GEMM +
        # p-wide trsm chain (88% of MXU peak -> unavoidable except
        # algorithmically) with thin (p, k) strip passes. Measured at cfg2
        # (512^2, p=5243): o110/p1 0.293 -> 0.194 s device at
        # 0.0000-0.0008 dB vs LOBPCG across 4 seeds; o206/p0 (one fewer
        # M-apply, k = 2x128 lanes) saves another ~7 ms at 0.0000-0.0001 dB
        # across 3 seeds (cfg2_sweep.jsonl sketch_*/skp0_* rows).
        # Gated on p large enough that the k-wide block is genuinely thin —
        # below that the dense chol/LOBPCG path is already cheap and exact.
        k_sketch = cfg.num_eigvecs + 206
        if p >= 4 * k_sketch:
            chosen.update(solver="sketch", sketch_oversample=206,
                          sketch_power=0)
        # strip_cache (r4): the same recipe through the STREAMING model
        # with the strip materialized once in NATURAL pixel order — no
        # [A; B] N-row feature permute (~20 ms of cfg2's affinity stage)
        # and the coarse Sinkhorn picks up the diagonal-offset anti-alias
        # sample (sinkhorn_sample_idx). Measured at cfg2: dense headline
        # 0.133 -> 0.120 s sync-walled device at 0.011-0.028 dB across 4
        # seeds with iters=6 (cfg2_sweep.jsonl scfold_it6* rows; the
        # permuted-stride dense twin needed 8). Routed as a GROUP only
        # when the caller kept none of the three coupled fields and the
        # strip fits the single-chip bound.
        if (not {"streaming", "strip_cache", "block_cols"} & set(keep)
                and chosen.get("sinkhorn_coarse", 0) > 1
                and chosen.get("solver") == "sketch"
                and p * n_pixels * 2 <= 8e9):
            chosen.update(streaming=True, strip_cache=True,
                          block_cols=n_pixels, sinkhorn_iters=6,
                          # r5: Pallas emitter + fused strip sweeps —
                          # 0.122 -> 0.116 s and peak HBM 10.74 -> 8.21
                          # GiB at cfg2 (cfg2_sweep.jsonl emit_* rows)
                          use_pallas=True)
    if cfg.filter_name == "sharpen" and cfg.filter_mode == "spectral":
        # Rank-m AFFINE filters are ill-posed on collapsed kernel spectra
        # (AFFINE_FILTERS note): every accelerated cfg3 recipe measured
        # 1.8-4.6 dB off the exact trajectory with polish/coarse depth
        # irrelevant (cfg3_sweep.jsonl). ALL preset levels — including
        # "exact", so parity twins compare like-to-like — route SHARPEN to
        # the exact polynomial matvec form, which is also faster (no
        # gram/eigensolve) and semantically right: f(0) = 1+beta passes
        # and boosts the out-of-rank residual, exactly the unsharp-mask
        # intent. TWICING is deliberately NOT routed despite sharing the
        # instability: its f(0) = 0 makes the true low-rank polynomial
        # KILL the residual whose add-back is twicing's whole point —
        # measured SSIM 0.26 (matvec) vs 0.87 (spectral basis replay) at
        # 512^2 (quality_sweep.jsonl cfg3_matvec_sharpen vs
        # cfg3_512_sharpen rows); accelerated-recipe parity for spectral
        # twicing carries the documented collapsed-spectrum caveat.
        # Explicit filter_mode in ``keep`` wins.
        chosen["filter_mode"] = "matvec"
    out = cfg.replace(**{k: v for k, v in chosen.items() if k not in keep})
    # Fused finish (streaming fast level): the coarse factor's four
    # full-res sweeps collapse into two Pallas passes with the spectrum
    # from the decimated post-polish rmatvec — measured 0.488 -> 0.394 s
    # device at 8 MP (17.2 -> 21.3 MP/s) at 0.0035-0.0116 dB across
    # seeds (cfg4_sweep.jsonl ffin2_* rows). Decided on the POST-keep
    # config so an explicitly kept knob (e.g. -sinkhorn_polish 0) can
    # never combine into an invalid fused config; operator filter modes
    # never build the factor, so the flag would be dead there. Shape
    # gates (p_pad, V cap) still fall back at runtime
    # (models/streaming._fused_finish_ok).
    if ("fused_finish" not in keep and level == "fast" and out.streaming
            and not out.strip_cache
            and out.use_pallas and out.normalization == "sinkhorn"
            and out.sinkhorn_coarse > 1 and out.sinkhorn_polish == 1
            and out.gram_coarse > 1 and not out.operator_filter()):
        out = out.replace(fused_finish=True)
    return out


def denoise_tuned(cfg: PipelineConfig, sigma: float,
                  keep: frozenset | set = frozenset()) -> PipelineConfig:
    """Noise-sigma-aware denoise recipe, from the measured quality
    calibrations (benchmarks/tune_quality.py sigma sweep, 648 rows across
    sigma in {0.05..0.2} x both kernels x filter families, results in
    benchmarks/results/quality_sweep.jsonl; round-4 rank study at
    512^2-8 MP in benchmarks/results/rank_study.jsonl):

    * gaussian: the pure photometric kernel barely denoises (+0.09 dB at
      the round-2 defaults) — the BILATERAL form is the lever. h = 2.0 sigma
      + spatial_h = 8 px is the cross-sigma optimum (within 0.05 dB of the
      per-sigma best at every tested sigma; +5.1 dB at sigma=0.1/128^2).
    * nlm + identity (the default denoiser): route to the EXACT full-rank
      operator — filter_mode='matvec' (z = W y, no gram/eigensolve) at
      h = 1.0 sigma. Measured vs the best rank-m spectral identity at
      sigma=0.1: +2.5 dB at 512^2, +2.1 at 1024^2, +3.4 dB at 8 MP
      (rank_study.jsonl x*/mv_* rows) — a rank-m reconstruction of an
      N-pixel image keeps only m spatial modes, which binds harder as N
      grows (rank-50 at 8 MP with a sharp kernel COLLAPSES to 10 dB),
      while the exact operator tolerates (and rewards) the sharper
      h = 1.0 sigma kernel. Spectral-mode nlm keeps the rank-m rule
      h = 1.5 sigma (explicit -filter_mode spectral, basis checkpointing,
      or 'lowpass' — which needs the basis by construction).

    Bandwidth floors keep the kernel non-degenerate on clean images.
    Fields named in ``keep`` are left untouched (CLI: explicit flags win).
    """
    if cfg.kernel == "gaussian":
        chosen = dict(h=max(2.0 * sigma, 0.08), spatial_h=8.0)
    elif (cfg.filter_name == "identity" and cfg.filter_mode == "spectral"
            and "filter_mode" not in keep):
        chosen = dict(h=max(1.0 * sigma, 0.05), filter_mode="matvec")
    elif cfg.filter_mode != "spectral" and cfg.filter_name == "identity":
        chosen = dict(h=max(1.0 * sigma, 0.05))
    else:
        chosen = dict(h=max(1.5 * sigma, 0.05))
    return cfg.replace(**{k: v for k, v in chosen.items() if k not in keep})


# The graded configs (BASELINE.md table). Bandwidths are the
# denoise_tuned() optima at the graded noise level sigma=0.1 (round-3
# quality calibration; the old CONFIG1 h=0.3/spatial_h=0 gained +0.09 dB,
# these gain +5.1/+6.5 dB on the graded shapes at identical runtime class).
CONFIG1 = PipelineConfig(
    kernel="gaussian", h=0.2, spatial_h=8.0, sample_rho=0.01, num_eigvecs=50,
    normalization="sinkhorn", sinkhorn_iters=20, filter_name="identity",
)
CONFIG2 = PipelineConfig(
    kernel="nlm", patch_size=5, h=0.15, sample_rho=0.02, num_eigvecs=50,
    normalization="sinkhorn", sinkhorn_iters=20, filter_name="identity",
)
# filter_mode="matvec": the sharpen polynomial is applied EXACTLY by strip
# matvecs (z = (1+b) y - b W y) — the rank-m spectral form is ill-posed here
# (AFFINE_FILTERS note; measured in cfg3_sweep.jsonl) and the matvec form
# also skips the gram + eigensolve, the streaming path's dominant cost.
# beta was re-calibrated FOR THE EXACT OPERATOR (quality_sweep.jsonl
# cfg3_matvec_sharpen rows): the full-spectrum mask boosts everything the
# coarse W-blur misses, so the spectral-mode beta=0.6 over-sharpens
# (gradient ratio 3.0, SSIM 0.77); beta=0.15 measures ratio 1.64 vs the
# noisy input's own ~1.25 (a real detail boost, not noise), SSIM 0.868
# (input 0.890) and PSNR 29.0 — the faithful-enhancement point. h matters
# little in matvec mode (the W-blur is coarse at any tested h); 0.15 stays
# for consistency with the NLM denoise calibration and spectral-mode use.
CONFIG3 = PipelineConfig(
    kernel="nlm", patch_size=5, h=0.15, sample_rho=0.01, sample_cap=4096,
    num_eigvecs=50, normalization="sinkhorn", filter_name="sharpen",
    filter_param=0.15, filter_mode="matvec",
)
