"""The Hopper Montgomery-multiply kernel: build, bind, launch, fold.

`mul(ctx, a, b)` is the port of `dds_tpu/ops/mont_mxu.py::mul2_lm` (the
Pallas product `_make_prod_kernel` + its XLA reduction `_redc`) and of
`dds_tpu/ops/pallas_mont.py::mul_lm` (the fused CIOS `_make_mul_kernel`):
a * b * R^-1 mod n on limbs-major (L, B) int32 arrays of 16-bit limbs,
canonical in and out. `reduce_mul(ctx, rows)` is the port of
`mont_mxu.reduce_mul2`: a halving tree of `mul` launches over the rows
padded to a power of two with R mod n, then one multiply by R^K mod n.

On a CUDA tensor `mul` launches `csrc/mont_mul.cu` (built with nvcc for
sm_90a at first use, bound with ctypes) or raises; on a CPU tensor it runs
the plain PyTorch CIOS of `ops/montgomery.py`. Nothing falls back from one
to the other. Each launch adds one to `launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops.montgomery import ModCtx

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "mont_mul.cu"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCount:
    """Thread-safe launch counter (folds launch from worker threads)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


launches = LaunchCount()

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc/ptxas output of this process's build ("" until built)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the build lands: keyed by a hash of the source and flags, so
    an edited source never loads a stale library."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmont_mul-{h.hexdigest()[:16]}.so"


def start_build() -> tuple[Path, Path, subprocess.Popen | None]:
    """Start nvcc for the kernel unless its library already exists; returns
    (library path, temporary output path, process or None). Callers that
    build several sources at once start them all, then `finish_build`
    each."""
    path = library_path()
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    if path.exists():
        return path, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return path, tmp, proc


def finish_build(path: Path, tmp: Path, proc: subprocess.Popen | None) -> str:
    """Wait for a build started by `start_build`; returns the compiler's
    output (registers, spills, shared memory from -Xptxas -v)."""
    global build_log
    if proc is None:
        return build_log
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {SOURCE}:\n{out}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    build_log = out
    kprof.note_build()
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, tmp, proc = start_build()
            finish_build(path, tmp, proc)
            lib = ctypes.CDLL(str(path))
            p, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.dds_mont_mul.argtypes = [p, ll, p, ll, p, ll, p, ctypes.c_uint,
                                         ctypes.c_int, ctypes.c_int, p]
            lib.dds_mont_mul.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dim() != 2 or x.shape[0] != ctx.L:
            raise ValueError(f"{name} must be limbs-major (L={ctx.L}, B), got {tuple(x.shape)}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 limbs, got {x.dtype}")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"{name} columns must be contiguous (stride 1)")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"device mismatch {a.device} vs {b.device}")
    if a.shape[1] < 1:
        raise ValueError("empty batch")


def mul(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod n, limbs-major (L, B) int32,
    canonical (< n) in and out. `a` and `b` may be column-slices of a
    wider array (row stride > B): a fold level passes its two halves as
    views. Returns a new contiguous (L, B) tensor."""
    _check(ctx, a, b)
    if a.device.type == "cpu":
        return ctx.mont_mul(a.T, b.T).T.contiguous()
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul runs on cuda or cpu, not {a.device}")
    lib = _library()
    L, B = a.shape
    out = torch.empty((L, B), dtype=torch.int32, device=a.device)
    words = ctx.consts(a.device)["N32"]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dds_mont_mul(
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), words.data_ptr(), ctx.n0inv32,
            L, B, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mont_mul launch failed: cudaError {rc} (L={L}, B={B})")
    launches.bump()
    return out


def fold_launches(K: int) -> int:
    """Kernel launches of one K-row fold: log2(P2) tree levels + the fix."""
    return max(1, (K - 1).bit_length()) + 1


def reduce_mul(ctx: ModCtx, rows: torch.Tensor) -> torch.Tensor:
    """Modular product of all K rows ((K, L) plain domain, K >= 1) as
    (1, L) int32 — `mont_mxu.reduce_mul2`'s contract. Pads K to
    P2 = 2^ceil(log2 K) (at least 2) rows with R mod n, transposes to
    limbs-major, halves the width with one `mul` per level, then
    multiplies once by R^K mod n."""
    K, L = rows.shape
    if K < 1 or L != ctx.L:
        raise ValueError(f"reduce_mul needs (K >= 1, L={ctx.L}) rows, got {tuple(rows.shape)}")
    P2 = 1 << max(1, (K - 1).bit_length())
    x = torch.empty((L, P2), dtype=torch.int32, device=rows.device)
    x[:, :K] = rows.T
    x[:, K:] = ctx.consts(rows.device)["one_mont"][:, None]
    w = P2
    while w > 1:
        h = w // 2
        x = mul(ctx, x[:, :h], x[:, h: 2 * h])
        w = h
    x = mul(ctx, x, ctx.fold_fix(K, rows.device))
    return x.T.contiguous()
