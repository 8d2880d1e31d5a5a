"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The sources in ``csrc/`` compile into one shared library with a plain C
interface: one nvcc process per source, all started together, then one
link. The build runs at first use (never at import), from the package's
own sources only, into ``_build/<hash>/`` beside the package; the hash
covers every source and the compiler flags, so an edited source rebuilds
and an unchanged one loads in milliseconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libosdm_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U32 = ctypes.c_uint32
SIGNATURES = {
    # A, lda, a_mut_cols, B, ldb, C, ldc, out_bf16, M, N, K, bias, row_add, ldr,
    # bn, splits, tma, partials, tickets, stream
    "osdm_gemm_bf16_f32acc": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                              _I, _I, _I, _P, _P, _P],
    # A, lda, B, ldb, out, ldo, M, N, K, bias, gn_scale, gn_bias, group, eps, bn, splits,
    # partials, tickets, stream
    "osdm_gemm_bf16_gn_silu": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _F, _I, _I,
                               _P, _P, _P],
    # A, lda, B, ldb, M, N, K, x, ldx, mut_dim, b_out, coeffs, step, mode, noise, seed, clip,
    # bn, splits, partials, tickets, stream
    "osdm_gemm_bf16_posterior": [_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P, _U32,
                                 _F, _I, _I, _P, _P, _P],
    # h, ldh, out, ldo, scale, bias, M, F, eps, stream
    "osdm_groupnorm8_silu": [_P, _I, _P, _I, _P, _P, _I, _I, _F, _P],
    # acc, lda, x, ldx, M, D, mut_dim, b_out, coeffs, step, mode, noise, seed, clip, stream
    "osdm_x0_posterior_step": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _U32, _F, _P],
    # A, lda, in_bf16, M, K, mut_cols, Q, ldq, scale, stream
    "osdm_rowquant_s8": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # A, lda, B, ldb, b_rows, C, ldc, out_bf16, M, N, K, row_scale, col_scale, accumulate,
    # bias, row_add, ldr, bn, splits, partials, tickets, stream
    "osdm_gemm_s8": [_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I,
                     _I, _I, _P, _P, _P],
    # A (bf16), lda, B, ldb, b_rows, C, ldc, out_bf16, M, N, K, col_scale, accumulate, bias,
    # row_add, ldr, bn, splits, partials, tickets, stream
    "osdm_gemm_s8q": [_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P,
                      _P, _P],
    # A (bf16), lda, B, ldb, b_rows, C, ldc, out, ldo, M, N, K, col_scale, accumulate, bias,
    # gn_scale, gn_bias, group, eps, bn, splits, partials, tickets, stream
    "osdm_gemm_s8q_gn_silu": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                              _I, _F, _I, _I, _P, _P, _P],
    # A (bf16), lda, B, ldb, b_rows, M, N, K, col_scale, x, ldx, mut_dim, b_out, coeffs, step,
    # mode, noise, seed, clip, bn, splits, partials, tickets, stream
    "osdm_gemm_s8q_posterior": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I,
                                _P, _U32, _F, _I, _I, _P, _P, _P],
    # A, lda, B, ldb, b_rows, C, ldc, out, ldo, M, N, K, row_scale, col_scale, accumulate,
    # bias, gn_scale, gn_bias, group, eps, bn, splits, partials, tickets, stream
    "osdm_gemm_s8_gn_silu": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                             _P, _I, _F, _I, _I, _P, _P, _P],
    # A, lda, B, ldb, b_rows, M, N, K, row_scale, col_scale, x, ldx, mut_dim, b_out, coeffs,
    # step, mode, noise, seed, clip, bn, splits, partials, tickets, stream
    "osdm_gemm_s8_posterior": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I,
                               _I, _P, _U32, _F, _I, _I, _P, _P, _P],
    # X, Y, n, m, d, gamma, same, bm, splits, xsq, ysq, slots, tickets, tile_sums, done, out,
    # stream
    "osdm_rbf_kernel_sum": [_P, _P, _I, _I, _I, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # h, ldh, m2, ldm, m_b, zeta_cur, l_t, ldl, s, c_proj, t_add, coeffs, n_lat, step, h_in, hacc,
    # xi, zeta_next, mode, zeta, seed, M, H, bn, splits, partials, tickets, stream
    "osdm_gemm_bf16_latent_step": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                                   _P, _P, _I, _P, _U32, _I, _I, _I, _I, _P, _P, _P],
    # h, hacc, xi, zeta_bf, M, H, coeffs, step, mode, zeta, seed, stream
    "osdm_latent_draw": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _U32, _P],
    # s, o_lat, n_inj, c_proj, t_add, coeffs, step, h_in, M, H, stream
    "osdm_latent_update": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    # x, pred, out, n, d, coefs, c0, c1, sv, add_noise, clip, seed, stream
    "osdm_posterior_update": [_P, _P, _P, _I, _I, _P, _F, _F, _F, _F, _F, _U32, _P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def build() -> Path:
    """Compile csrc/*.cu into the hashed build directory (no-op when the
    library for the current sources exists). Returns the library path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Build in a private directory, then rename the library: concurrent
    # builds never load a half-written one.
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        sources = sorted(CSRC_DIR.glob("*.cu"))
        objs = [os.path.join(work, cu.stem + ".o") for cu in sources]
        _run_all([[nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", obj, str(cu)]
                  for obj, cu in zip(objs, sources)], work)
        tmp = os.path.join(work, LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]], work)
        os.replace(tmp, lib_path)
    return lib_path


def _run_all(cmds, work: str) -> None:
    """Run the commands in parallel (output to files, so no pipe fills),
    wait for every one, then raise with the first failure's output."""
    runs = []
    for i, cmd in enumerate(cmds):
        log = os.path.join(work, f"nvcc_{i}.log")
        with open(log, "w") as f:
            runs.append((cmd, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    for _, _, proc in runs:
        proc.wait()
    for cmd, log, proc in runs:
        if proc.returncode != 0:
            with open(log) as f:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{f.read()}")


class _Library:
    """The loaded kernel library, built on first use."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = _Library()


def check(status: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
