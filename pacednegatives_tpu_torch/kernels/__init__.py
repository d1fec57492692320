"""Build and load the port's hand-written CUDA kernels.

The sources are ``pacednegatives_tpu_torch/csrc/*.cu`` and the headers they
share (``csrc/*.cuh``). On first use each source is compiled by its own
``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library goes into ``pacednegatives_tpu_torch/_build/``
(git-ignored), named by a hash of the sources, headers and flags, so an
edited source or header rebuilds it and an unchanged tree does not.
Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("gemm_bf16.cu", "t5_attention_fwd.cu", "t5_attention_bwd.cu",
           "t5_attention_bwd_fp32.cu", "mips_topk.cu", "embed_grad.cu",
           "moe_gemm.cu")
HEADERS = ("hopper_pipeline.cuh", "t5_attention_bwd.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills, kept in the build log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: (argtypes) -> int cudaError_t
_SIGNATURES = {
    # A, B, C, M, N, K, lda, ldb, ldc, device, stream
    "pnt_gemm_bf16": (_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _I, _P),
    # q, k, v, q strides (b, h, l), kv strides (b, h, l), pos, key_mask,
    # out, out strides (b, h, l), out_f32, m, l, B, H, Lq, Lk, dk, device,
    # stream
    "pnt_t5_attention_fwd": (
        _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P,
        _P, _LL, _LL, _LL, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    # q, k, v, q strides (b, h, l), kv strides, g, g strides, pos, key_mask,
    # m, l, dq, dq strides, dk, dv, dkv strides, out, out strides, delta,
    # dpos_part, dpos, B, H, Lq, Lk, dk, rows_per_group, device, stream
    "pnt_t5_attention_bwd": (
        _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL,
        _P, _P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL,
        _P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # q, k, v, q strides, kv strides, g, g strides, pos, key_mask, m, l,
    # dcap, scratch, dq, dk, dv, dpos_part, dpos, B, H, Lq, Lk, dk,
    # rows_per_group, fp32_operands, device, stream
    "pnt_t5_attention_core_bwd": (
        _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # B, H, Lq, Lk, dk, fp32_operands, device, &bytes: its scratch bytes
    "pnt_t5_attention_core_bwd_scratch": (
        _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_LL),
    ),
    # q, q_hi, q_lo, docs, scales, scores, cand, B, N, D, seg_len, nseg,
    # kk, doc_type (0 fp32, 1 bf16, 2 int8), device, stream
    "pnt_mips_topk_sets": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P),
    # keys, values, indices, n, device, stream
    "pnt_mips_unpack_keys": (_P, _P, _P, _LL, _I, _P),
    # g, ids, ids' bytes (4 or 8), out, scratch, n, d, vocab, dtype (0
    # bf16, 1 fp32), vec, device, stream
    "pnt_embed_grad": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # n, d, vocab, &bytes: its scratch bytes
    "pnt_embed_grad_scratch": (_I, _I, _I, ctypes.POINTER(_LL)),
    # A, B, C, offs, E, rows, K, N, mode (0 rows grouped, 1 dW), device,
    # stream
    "pnt_moe_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libpnt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing.

    One ``nvcc -c`` per source, all started together, then one link.
    Returns (library path, seconds spent compiling; 0.0 if it was there).
    The compilers' output (including ``-Xptxas -v``) is written beside the
    library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    tmp = so.with_name(f"{tag}.tmp.so")
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)]
            for src, obj in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(c, o, p.returncode) for c, o, p in zip(cmds, outputs, procs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        outputs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((link, outputs[-1], proc.returncode))
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + o for c, o in zip([*cmds, link], outputs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n"
                           f"{out[-6000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, seconds


def build_log() -> str:
    """The compiler output of the last build of the current sources."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument types declared so pointers are not cut to 32 bits."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
