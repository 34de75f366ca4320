"""The Hopper Montgomery kernels: build, bind, launch; fold and modexp.

`mul(ctx, a, b)` is the port of `dds_tpu/ops/mont_mxu.py::mul2_lm` (the
Pallas product `_make_prod_kernel` + its XLA reduction `_redc`) and of
`dds_tpu/ops/pallas_mont.py::mul_lm` (the fused CIOS `_make_mul_kernel`):
a * b * R^-1 mod n on limbs-major (L, B) int32 arrays of 16-bit limbs,
canonical in and out. `reduce_mul(ctx, rows)` is the port of
`mont_mxu.reduce_mul2`: a halving tree of `mul` launches over the rows
padded to a power of two with R mod n, then one multiply by R^K mod n.

`exp(ctx, base_mont, digits)` is the port of `pallas_mont.exp_lm` (the
Pallas window ladder `_make_exp_kernel`): base^exp in the Montgomery
domain for a shared exponent given as MSB-first 4-bit digits. `pow_mod(ctx,
bases, exp)` has `pallas_mont.pow_mod`'s (and `mont_mxu.pow_mod2`'s)
contract: domain entry with `mul` by R^2, the ladder, exit with `mul` by 1.

On a CUDA tensor each wrapper launches its kernel — `csrc/mont_mul.cu` or
`csrc/mont_exp.cu`, each built with nvcc for sm_90a at first use and bound
with ctypes — or raises; on a CPU tensor it runs the plain PyTorch version
of `ops/montgomery.py`. Nothing falls back from one to the other. Each
launch adds one to its kernel's counter: `launches` (mont_mul) or
`exp_launches` (mont_exp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits

CSRC = Path(__file__).resolve().parent.parent / "csrc"
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


launches = LaunchCount()      # mont_mul.cu
exp_launches = LaunchCount()  # mont_exp.cu


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


class KernelLib:
    """One `csrc/` source: its nvcc build into `csrc/build/` (once per
    process, under the source's lock) and its ctypes binding. `symbol` is
    the C entry point and `argtypes` its signature."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.build_log = ""  # nvcc/ptxas output of this process's build
        self._lock = threading.Lock()
        self._fn = None

    def library_path(self) -> Path:
        """Where the build lands: keyed by a hash of the source and flags,
        so an edited source never loads a stale library."""
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> tuple[Path, Path, subprocess.Popen | None]:
        """Start nvcc unless the library already exists; returns (library
        path, temporary output path, process or None). Callers that build
        several sources at once start them all, then `finish_build` each."""
        path = self.library_path()
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        if path.exists():
            return path, tmp, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return path, tmp, proc

    def finish_build(self, path: Path, tmp: Path,
                     proc: subprocess.Popen | None) -> str:
        """Wait for a build started by `start_build`; returns the compiler's
        output (registers, spills, shared memory from -Xptxas -v)."""
        if proc is None:
            return self.build_log
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {self.source}:\n{out}")
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        self.build_log = out
        kprof.note_build()
        return out

    def function(self):
        """The bound C entry point, building the library on first use."""
        with self._lock:
            if self._fn is None:
                path, tmp, proc = self.start_build()
                self.finish_build(path, tmp, proc)
                fn = getattr(ctypes.CDLL(str(path)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn


_p, _ll, _i, _u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
MUL = KernelLib("mont_mul.cu", "dds_mont_mul",
                [_p, _ll, _p, _ll, _p, _ll, _p, _u, _i, _i, _p])
EXP = KernelLib("mont_exp.cu", "dds_mont_exp",
                [_p, _ll, _p, _ll, _p, _p, _i, _p, _p, _u, _i, _i, _p])
KERNELS = (MUL, EXP)


def _check_operand(ctx: ModCtx, name: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != ctx.L:
        raise ValueError(f"{name} must be limbs-major (L={ctx.L}, B), got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 limbs, got {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} columns must be contiguous (stride 1)")
    if x.shape[1] < 1:
        raise ValueError("empty batch")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the Montgomery kernels run on cuda or cpu, not {x.device}")


def _check(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        _check_operand(ctx, name, x)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"device mismatch {a.device} vs {b.device}")


def mul(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod n, limbs-major (L, B) int32,
    canonical (< n) in and out. `a` and `b` may be column-slices of a
    wider array (row stride > B): a fold level passes its two halves as
    views. Returns a new contiguous (L, B) tensor."""
    _check(ctx, a, b)
    if a.device.type == "cpu":
        return ctx.mont_mul(a.T, b.T).T.contiguous()
    fn = MUL.function()
    L, B = a.shape
    out = torch.empty((L, B), dtype=torch.int32, device=a.device)
    words = ctx.consts(a.device)["N32"]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
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


def exp(ctx: ModCtx, base_mont: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """base^exp in the Montgomery domain — `pallas_mont.exp_lm`'s contract.
    `base_mont`: limbs-major (L, B) int32, canonical, Montgomery domain;
    `digits`: (E,) int32 MSB-first 4-bit digits (`_exp_to_digits`) on the
    same device, each taken mod 16. Returns a new contiguous (L, B)."""
    _check_operand(ctx, "base", base_mont)
    if digits.dim() != 1 or digits.shape[0] < 1 or digits.dtype != torch.int32:
        raise ValueError(f"digits must be a non-empty (E,) int32 tensor, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    if digits.device != base_mont.device:
        raise ValueError(f"device mismatch {base_mont.device} vs {digits.device}")
    if base_mont.device.type == "cpu":
        return ctx.mont_exp(base_mont.T, digits).T.contiguous()
    fn = EXP.function()
    L, B = base_mont.shape
    digits = digits.contiguous()
    out = torch.empty((L, B), dtype=torch.int32, device=base_mont.device)
    table = torch.empty((16, ctx.W, B), dtype=torch.int32, device=base_mont.device)
    c = ctx.consts(base_mont.device)
    with torch.cuda.device(base_mont.device):
        stream = torch.cuda.current_stream(base_mont.device).cuda_stream
        rc = fn(
            base_mont.data_ptr(), base_mont.stride(0), out.data_ptr(), out.stride(0),
            table.data_ptr(), digits.data_ptr(), digits.shape[0],
            c["N32"].data_ptr(), c["one_mont"].data_ptr(), ctx.n0inv32, L, B, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mont_exp launch failed: cudaError {rc} "
                           f"(L={L}, B={B}, E={digits.shape[0]})")
    exp_launches.bump()
    return out


def pow_mod(ctx: ModCtx, bases: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain-domain bases^exp mod n for canonical batch-major (B, L)
    `bases` and a shared host-int exponent — `pallas_mont.pow_mod`'s
    contract, (B, L) int32 out. exp = 0 gives ones without a launch;
    otherwise `mul` by R^2 (materialised (L, B): the kernels take no
    broadcast column), the `exp` ladder, and `mul` by 1."""
    B, L = bases.shape
    if L != ctx.L or B < 1:
        raise ValueError(f"pow_mod needs (B >= 1, L={ctx.L}) bases, got {tuple(bases.shape)}")
    dev = bases.device
    if exponent == 0:
        one = torch.zeros((B, L), dtype=torch.int32, device=dev)
        one[:, 0] = 1
        return one
    digits = torch.from_numpy(_exp_to_digits(exponent).astype(np.int32)).to(dev)
    x = bases.T.contiguous()
    r2 = torch.from_numpy(ctx.R2.astype(np.int32)).to(dev)[:, None].expand(L, B).contiguous()
    xm = mul(ctx, x, r2)
    r = exp(ctx, xm, digits)
    one = torch.zeros((L, B), dtype=torch.int32, device=dev)
    one[0] = 1
    return mul(ctx, r, one).T.contiguous()
