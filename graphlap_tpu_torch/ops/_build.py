"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` (one nvcc
process a source, all started together) and the objects link into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import: modules of the port import on machines
without a CUDA toolkit) into ``build/torch_kernels/`` beside the package,
named by a hash of the sources, their shared ``csrc/*.cuh`` headers and
the flags, so an edited source or header rebuilds. ``build/`` is
git-ignored.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# C signatures (all kernels return cudaGetLastError() as an int)
_SIGNATURES = {
    "glt_affinity_scratch_bytes": ([_I, _I], _Z),
    "glt_affinity_strip": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "glt_ext2_smem_bytes": ([_I, _I, _I], _Z),
    "glt_ext2_strip_clusters": ([_I, _I, _I], _I),
    "glt_strip_ext2": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "glt_strip_sandwich": ([_P] * 10 + [_I] * 5 + [_P], _I),
    # K2-K4 on an f32 strip (the "highest" class)
    "glt_strip_ext2_f32_smem_bytes": ([_I, _I, _I], _Z),
    "glt_strip_ext2_f32_clusters": ([_I, _I, _I], _I),
    "glt_strip_ext2_f32": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "glt_strip_sandwich_f32": ([_P] * 12 + [_I] * 5 + [_P], _I),
    "glt_kb_strip": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "glt_kb_entries": ([_P, _P], _I),
    "glt_ext2_clusters": ([_I, _I], _I),
    "glt_ext2_matvec": ([_P] * 7 + [_I, _I, _I, _I, _P], _I),
    "glt_finish_colstats": ([_P] * 14 + [_I] * 5 + [_P], _I),
    "glt_recompute_slots": ([_I, _I], _I),
    "glt_recompute_sum": ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "glt_aug_entries": ([_P, _I, _P], _I),
    "glt_colstats_v_blocks": ([_I, _I], _I),
    "glt_colstats_v": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "glt_kexp_bf16": ([_P, _P, _Z, _P], _I),
    # the IEEE f32 cross: K1 and K5/K6 on coordinates, K7-K10 f32 layouts
    "glt_coord_store_slots": ([_I, _I], _I),
    "glt_affinity_coord": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "glt_coord_slots": ([_I], _I),
    "glt_coord_sum": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "glt_kb_strip_f32": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "glt_ext2_f32_clusters": ([_I, _I, _I], _I),
    "glt_ext2_matvec_f32": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "glt_colstats_f32_blocks": ([_I, _I], _I),
    "glt_colstats_f32_scratch_bytes": ([_I, _I, _I], _Z),
    "glt_colstats_v_f32": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "glt_finish_colstats_f32": ([_P] * 14 + [_I] * 4 + [_P], _I),
}

_LIB = None
BUILD_SECONDS: float | None = None   # wall of the last build in this process
PTXAS_LOG: str = ""                  # nvcc's -Xptxas -v report of that build


def _nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit (CUDA_HOME or PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libglt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global BUILD_SECONDS, PTXAS_LOG
    out = lib_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}"
            for src, proc in zip(sources(), procs)]
    PTXAS_LOG = "\n".join(logs)
    bad = [(src.name, log) for src, proc, log in zip(sources(), procs, logs)
           if proc.returncode]
    if bad:
        raise RuntimeError(f"nvcc failed on {[b[0] for b in bad]}:\n"
                           + "\n".join(log[-6000:] for _, log in bad))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc={proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = so
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
