"""The Hopper Montgomery kernels: build, bind, launch; fold and modexp.

`mul(ctx, a, b, karatsuba)` is the port of `dds_tpu/ops/mont_mxu.py::
mul2_lm` and of `dds_tpu/ops/pallas_mont.py::mul_lm`: a * b * R^-1 mod n on
limbs-major (L, B) int32 arrays of 16-bit limbs, canonical in and out, by
the family DDS_KARATSUBA selects (`flags.karatsuba_mode`):
- 0: the fused CIOS kernel (B1, which also serves B2);
- 1 / k1: `karatsuba.prod_k1` (the half sums, B4, the recombination:
  three launches), then `redc`;
- 2 / fused: `karatsuba.prod_kf` (B5), then `redc`.
`reduce_mul(ctx, rows)` is the port of `mont_mxu.reduce_mul2`: a halving
tree of `mul` over the rows padded to a power of two with R mod n, then
one multiply by R^K mod n, every level in the family read once per fold.
`mul_nofinal` is the CIOS kernel without its final subtraction, the probe
P of `benchmarks/profile_kernel.py::make_nofinal_mul`.

`exp(ctx, base_mont, digits)` is the port of `pallas_mont.exp_lm` (the
Pallas window ladder `_make_exp_kernel`, B3): base^exp in the Montgomery
domain for a shared exponent given as MSB-first 4-bit digits. `pow_mod(ctx,
bases, exp)` has `pallas_mont.pow_mod`'s (and `mont_mxu.pow_mod2`'s)
contract: domain entry with `mul` by R^2, the ladder, exit with `mul` by 1.

`mul_rowmod` and `exp_rowmod` are the same product and ladder with one
modulus (and one exponent) a column, the device math of the Sanctum
decrypt (`sanctum/device.py`): the ports of the reference's XLA functions
`montgomery._mont_mul_rowmod_raw` and `_mont_exp_rowdigits_raw`. They take
every constant as an explicit tensor and no `ModCtx`, so no secret
modulus can reach a context's device-constant cache.

Seven sources under `csrc/`, each built with nvcc for sm_90a at first use
and bound with ctypes (`KernelLib`, one lock per source):
- `mont_mul.cu`: `dds_mont_mul` (B1) and `dds_mont_mul_nofinal` (P);
- `mont_exp.cu` (B3);
- `mont_prod3.cu` (B4);
- `mont_kfused.cu` (B5);
- `mont_redc.cu`: the reduction after B4 and B5 (`mont_mxu._redc`, which
  is XLA code in the reference, not a Pallas kernel);
- `mont_k1.cu`: `dds_k1_halfsums` and `dds_k1_combine`, the half sums
  before B4 and the recombination after it (`mont_mxu.carry_norm` and
  `_karatsuba_combine` in `prod_lm_k1`, XLA code in the reference);
- `mont_rowmod.cu`: `dds_mont_mul_rowmod` and `dds_mont_exp_rowmod`, the
  per-column-modulus product and ladder.
All run one warp a column on the core `mont_warp.cuh`.
On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version of `ops/montgomery.py`. Nothing
falls back from one to the other. Each launch adds one to its kernel's
counter (`LAUNCHES`).
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
from dds_tpu_torch.ops import flags, montgomery
from dds_tpu_torch.ops.bignum import int_to_limbs
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


launches = LaunchCount()          # mont_mul.cu, dds_mont_mul (B1)
exp_launches = LaunchCount()      # mont_exp.cu (B3)
prod3_launches = LaunchCount()    # mont_prod3.cu (B4)
kfused_launches = LaunchCount()   # mont_kfused.cu (B5)
redc_launches = LaunchCount()     # mont_redc.cu (the reduction of B4 and B5)
nofinal_launches = LaunchCount()  # mont_mul.cu, dds_mont_mul_nofinal (P)
halfsums_launches = LaunchCount()  # mont_k1.cu, dds_k1_halfsums
combine_launches = LaunchCount()  # mont_k1.cu, dds_k1_combine
mul_rowmod_launches = LaunchCount()  # mont_rowmod.cu, dds_mont_mul_rowmod
exp_rowmod_launches = LaunchCount()  # mont_rowmod.cu, dds_mont_exp_rowmod
# every kernel's counter by the name chip_smoke.py reports it under
LAUNCHES = {
    "mont_mul": launches, "mont_exp": exp_launches, "mont_prod3": prod3_launches,
    "mont_kfused": kfused_launches, "mont_redc": redc_launches,
    "mont_mul_nofinal": nofinal_launches, "mont_k1_halfsums": halfsums_launches,
    "mont_k1_combine": combine_launches, "mont_mul_rowmod": mul_rowmod_launches,
    "mont_exp_rowmod": exp_rowmod_launches,
}


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
    process, under the source's lock) and its ctypes bindings. `symbols`
    maps each C entry point to its signature; the first is the default."""

    def __init__(self, source: str, symbols: dict[str, list]):
        self.source = CSRC / source
        self.symbols = symbols
        self.build_log = ""  # nvcc/ptxas output of this process's build
        self._lock = threading.Lock()
        self._fns: dict = {}

    def library_path(self) -> Path:
        """Where the build lands: keyed by a hash of the source, every
        header beside it (`*.cuh`) and the flags, so an edited source or
        header never loads a stale library."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
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

    def function(self, symbol: str | None = None):
        """A bound C entry point (the first of `symbols` by default),
        building and loading the library on first use."""
        symbol = symbol or next(iter(self.symbols))
        with self._lock:
            if not self._fns:
                path, tmp, proc = self.start_build()
                self.finish_build(path, tmp, proc)
                lib = ctypes.CDLL(str(path))
                for name, argtypes in self.symbols.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    self._fns[name] = fn
            return self._fns[symbol]


_p, _ll, _i, _u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
_MUL_ARGS = [_p, _ll, _p, _ll, _p, _ll, _p, _u, _i, _i, _p]
MUL = KernelLib("mont_mul.cu", {"dds_mont_mul": _MUL_ARGS,
                                "dds_mont_mul_nofinal": _MUL_ARGS})
EXP = KernelLib("mont_exp.cu", {"dds_mont_exp":
                                [_p, _ll, _p, _ll, _p, _i, _p, _p, _u, _i, _i, _p]})
PROD3 = KernelLib("mont_prod3.cu", {"dds_mont_prod3": [_p, _ll] * 7 + [_i, _i, _p]})
KFUSED = KernelLib("mont_kfused.cu", {"dds_mont_kfused": [_p, _ll] * 3 + [_i, _i, _p]})
REDC = KernelLib("mont_redc.cu", {"dds_mont_redc": [_p, _ll, _p, _ll, _p, _u, _i, _i, _p]})
K1 = KernelLib("mont_k1.cu", {"dds_k1_halfsums": [_p, _ll] * 3 + [_i, _i, _p],
                              "dds_k1_combine": [_p, _ll] * 3 + [_i, _i, _p]})
ROWMOD = KernelLib("mont_rowmod.cu", {
    "dds_mont_mul_rowmod": [_p, _ll, _p, _ll, _p, _ll, _p, _p, _i, _i, _p],
    "dds_mont_exp_rowmod": [_p, _ll, _p, _ll, _p, _ll, _i, _p, _p, _p, _ll, _i, _i, _p]})
KERNELS = (MUL, EXP, PROD3, KFUSED, REDC, K1, ROWMOD)


def _check_operand(name: str, x: torch.Tensor, rows: int) -> None:
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} must be limbs-major ({rows}, B), got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 limbs, got {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} columns must be contiguous (stride 1)")
    if x.shape[1] < 1:
        raise ValueError("empty batch")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the Montgomery kernels run on cuda or cpu, not {x.device}")


def _check(rows: int, **operands: torch.Tensor) -> torch.Tensor:
    """Validate same-shape, same-device operands; returns the first."""
    first = next(iter(operands.values()))
    for name, x in operands.items():
        _check_operand(name, x, rows)
        if x.shape != first.shape:
            raise ValueError(f"shape mismatch {tuple(first.shape)} vs {tuple(x.shape)}")
        if x.device != first.device:
            raise ValueError(f"device mismatch {first.device} vs {x.device}")
    return first


def _launch(lib: KernelLib, symbol: str, counter: LaunchCount, device,
            *args, what: str) -> None:
    """Call a kernel's C entry point on the current stream of `device`,
    raise on a refused launch, and count it."""
    fn = lib.function(symbol)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc} ({what})")
    counter.bump()


def _mul_cios(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor, final: bool) -> torch.Tensor:
    if a.device.type == "cpu":
        plain = ctx.mont_mul if final else ctx.mont_mul_nofinal
        return plain(a.T, b.T).T.contiguous()
    L, B = a.shape
    out = torch.empty((L, B), dtype=torch.int32, device=a.device)
    symbol, counter = (("dds_mont_mul", launches) if final
                       else ("dds_mont_mul_nofinal", nofinal_launches))
    _launch(MUL, symbol, counter, a.device,
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), ctx.consts(a.device)["N32"].data_ptr(),
            ctx.n0inv32, L, B, what=f"L={L}, B={B}")
    return out


def mul(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor,
        karatsuba: str | bool | None = None) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod n, limbs-major (L, B) int32,
    canonical (< n) in and out. `a` and `b` may be column-slices of a
    wider array (row stride > B): a fold level passes its two halves as
    views. Returns a new contiguous (L, B) tensor.

    `karatsuba` picks the product family, `mont_mxu.mul2_lm`'s contract:
    None reads DDS_KARATSUBA (`flags.karatsuba_mode`); False runs the CIOS
    kernel; "k1" is `karatsuba.prod_k1` then `redc`, "fused" is
    `karatsuba.prod_kf` then `redc` — at limb counts the Karatsuba shape
    rule admits (`karatsuba.fits`), the CIOS kernel at every other."""
    _check(ctx.L, a=a, b=b)
    mode = flags.karatsuba_mode() if karatsuba is None else karatsuba
    if mode:
        from dds_tpu_torch.ops import karatsuba as kara

        if kara.fits(ctx.L):
            T = kara.prod_kf(a, b) if mode == "fused" else kara.prod_k1(a, b)
            return redc(ctx, T)
    return _mul_cios(ctx, a, b, final=True)


def mul_nofinal(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CIOS product without its final subtraction (the probe P of
    `benchmarks/profile_kernel.py::make_nofinal_mul`): the low L limbs of
    t = (a*b + m*n) / R < 2n, limbs-major (L, B) int32, for canonical
    operands as `mul` takes them. `mul` is this, or this minus n."""
    _check(ctx.L, a=a, b=b)
    return _mul_cios(ctx, a, b, final=False)


def prod3(a0, b0, a1, b1, sa, sb) -> torch.Tensor:
    """The three half products of one Karatsuba level in one launch (B4):
    six canonical limbs-major (h, B) int32 operands (row slices allowed)
    -> (6h, B) int32 canonical blocks [a0*b0 | a1*b1 | sa*sb]."""
    h = a0.shape[0] if a0.dim() == 2 else -1
    ops = dict(a0=a0, b0=b0, a1=a1, b1=b1, sa=sa, sb=sb)
    first = _check(h, **ops)
    if first.device.type == "cpu":
        return montgomery.prod3(*(x.T for x in ops.values())).T.contiguous()
    B = first.shape[1]
    out = torch.empty((6 * h, B), dtype=torch.int32, device=first.device)
    args = [v for x in ops.values() for v in (x.data_ptr(), x.stride(0))]
    _launch(PROD3, "dds_mont_prod3", prod3_launches, first.device,
            *args, out.data_ptr(), out.stride(0), h, B, what=f"h={h}, B={B}")
    return out


def k1_halfsums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The half sums of one Karatsuba level (`mont_k1.cu`,
    `dds_k1_halfsums`): canonical limbs-major (L, B) int32 a and b, L a
    multiple of 4 (column slices allowed) -> (L + 2, B) int32 rows
    [sa | sb | ca | cb], h = L/2, sa = (a0 + a1) mod 2^(16h) canonical and
    ca its 0/1 overflow bit, the same for b."""
    L = a.shape[0] if a.dim() == 2 else -1
    _check(L, a=a, b=b)
    if L % 4:
        raise ValueError(f"k1_halfsums needs L a multiple of 4, got L={L}")
    if a.device.type == "cpu":
        return montgomery.k1_halfsums(a.T, b.T).T.contiguous()
    B = a.shape[1]
    out = torch.empty((L + 2, B), dtype=torch.int32, device=a.device)
    _launch(K1, "dds_k1_halfsums", halfsums_launches, a.device,
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), L, B, what=f"L={L}, B={B}")
    return out


def k1_combine(z: torch.Tensor, s: torch.Tensor, L: int) -> torch.Tensor:
    """The recombination of one Karatsuba level (`mont_k1.cu`,
    `dds_k1_combine`): B4's (3L, B) int32 [z0 | z2 | z1] (`prod3`) and the
    (L + 2, B) half sums (`k1_halfsums`) -> the canonical (2L, B) int32
    product a*b, L a multiple of 4."""
    if L < 4 or L % 4:
        raise ValueError(f"k1_combine needs L a multiple of 4, got L={L}")
    _check_operand("z", z, 3 * L)
    _check_operand("s", s, L + 2)
    if s.shape[1] != z.shape[1] or s.device != z.device:
        raise ValueError(f"z {tuple(z.shape)} on {z.device} and s {tuple(s.shape)} on "
                         f"{s.device} must share the batch and the device")
    if z.device.type == "cpu":
        return montgomery.k1_combine(z.T, s.T, L).T.contiguous()
    B = z.shape[1]
    out = torch.empty((2 * L, B), dtype=torch.int32, device=z.device)
    _launch(K1, "dds_k1_combine", combine_launches, z.device,
            z.data_ptr(), z.stride(0), s.data_ptr(), s.stride(0),
            out.data_ptr(), out.stride(0), L, B, what=f"L={L}, B={B}")
    return out


def prod_kf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b by one Karatsuba level in one launch (B5): canonical
    limbs-major (L, B) int32, L a multiple of 4 -> (2L, B) canonical."""
    L = a.shape[0] if a.dim() == 2 else -1
    _check(L, a=a, b=b)
    if L % 4:
        raise ValueError(f"prod_kf needs L a multiple of 4, got L={L}")
    if a.device.type == "cpu":
        return montgomery.prod_kf(a.T, b.T).T.contiguous()
    B = a.shape[1]
    out = torch.empty((2 * L, B), dtype=torch.int32, device=a.device)
    _launch(KFUSED, "dds_mont_kfused", kfused_launches, a.device,
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), L, B, what=f"L={L}, B={B}")
    return out


def redc(ctx: ModCtx, T: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction T * R^-1 mod n of a canonical limbs-major
    (2L, B) int32 product T < n*R: (L, B) int32 canonical (`mont_redc.cu`,
    the port of `mont_mxu._redc`)."""
    _check(2 * ctx.L, T=T)
    if T.device.type == "cpu":
        return ctx.redc(T.T).T.contiguous()
    B = T.shape[1]
    out = torch.empty((ctx.L, B), dtype=torch.int32, device=T.device)
    _launch(REDC, "dds_mont_redc", redc_launches, T.device,
            T.data_ptr(), T.stride(0), out.data_ptr(), out.stride(0),
            ctx.consts(T.device)["N32"].data_ptr(), ctx.n0inv32, ctx.L, B,
            what=f"L={ctx.L}, B={B}")
    return out


def fold_launches(K: int) -> int:
    """Multiplies of one K-row fold: log2(P2) tree levels + the fix. Each
    is one mont_mul launch, or two (a product and `redc`) in a Karatsuba
    mode."""
    return max(1, (K - 1).bit_length()) + 1


def reduce_mul(ctx: ModCtx, rows: torch.Tensor,
               karatsuba: str | bool | None = None) -> torch.Tensor:
    """Modular product of all K rows ((K, L) plain domain, K >= 1) as
    (1, L) int32 — `mont_mxu.reduce_mul2`'s contract. Pads K to
    P2 = 2^ceil(log2 K) (at least 2) rows with R mod n, transposes to
    limbs-major, halves the width with one `mul` per level, then
    multiplies once by R^K mod n. The product family is read once
    (`karatsuba`, None = DDS_KARATSUBA) and passed to every level, so one
    fold never mixes families."""
    K, L = rows.shape
    if K < 1 or L != ctx.L:
        raise ValueError(f"reduce_mul needs (K >= 1, L={ctx.L}) rows, got {tuple(rows.shape)}")
    mode = flags.karatsuba_mode() if karatsuba is None else karatsuba
    P2 = 1 << max(1, (K - 1).bit_length())
    x = torch.empty((L, P2), dtype=torch.int32, device=rows.device)
    x[:, :K] = rows.T
    x[:, K:] = ctx.consts(rows.device)["one_mont"][:, None]
    w = P2
    while w > 1:
        h = w // 2
        x = mul(ctx, x[:, :h], x[:, h: 2 * h], mode)
        w = h
    x = mul(ctx, x, ctx.fold_fix(K, rows.device), mode)
    return x.T.contiguous()


def exp(ctx: ModCtx, base_mont: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """base^exp in the Montgomery domain — `pallas_mont.exp_lm`'s contract.
    `base_mont`: limbs-major (L, B) int32, canonical, Montgomery domain;
    `digits`: (E,) int32 MSB-first 4-bit digits (`_exp_to_digits`) on the
    same device, each taken mod 16. Returns a new contiguous (L, B)."""
    _check(ctx.L, base=base_mont)
    if digits.dim() != 1 or digits.shape[0] < 1 or digits.dtype != torch.int32:
        raise ValueError(f"digits must be a non-empty (E,) int32 tensor, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    if digits.device != base_mont.device:
        raise ValueError(f"device mismatch {base_mont.device} vs {digits.device}")
    if base_mont.device.type == "cpu":
        return ctx.mont_exp(base_mont.T, digits).T.contiguous()
    L, B = base_mont.shape
    digits = digits.contiguous()
    out = torch.empty((L, B), dtype=torch.int32, device=base_mont.device)
    c = ctx.consts(base_mont.device)
    _launch(EXP, "dds_mont_exp", exp_launches, base_mont.device,
            base_mont.data_ptr(), base_mont.stride(0), out.data_ptr(), out.stride(0),
            digits.data_ptr(), digits.shape[0],
            c["N32"].data_ptr(), c["one_mont"].data_ptr(), ctx.n0inv32, L, B,
            what=f"L={L}, B={B}, E={digits.shape[0]}")
    return out


def pow_mod(ctx: ModCtx, bases: torch.Tensor, exponent: int,
            karatsuba: str | bool | None = None) -> torch.Tensor:
    """Plain-domain bases^exp mod n for canonical batch-major (B, L)
    `bases` and a shared host-int exponent — `pallas_mont.pow_mod`'s
    contract, (B, L) int32 out. exp = 0 gives ones without a launch;
    otherwise `mul` by R^2 (materialised (L, B): the kernels take no
    broadcast column), the `exp` ladder, and `mul` by 1. The two domain
    multiplies take the product family (`karatsuba`, read once, None =
    DDS_KARATSUBA); the ladder is the exp kernel's CIOS in every family,
    which gives the same values."""
    B, L = bases.shape
    if L != ctx.L or B < 1:
        raise ValueError(f"pow_mod needs (B >= 1, L={ctx.L}) bases, got {tuple(bases.shape)}")
    dev = bases.device
    if exponent == 0:
        one = torch.zeros((B, L), dtype=torch.int32, device=dev)
        one[:, 0] = 1
        return one
    mode = flags.karatsuba_mode() if karatsuba is None else karatsuba
    digits = torch.from_numpy(_exp_to_digits(exponent).astype(np.int32)).to(dev)
    x = bases.T.contiguous()
    r2 = torch.from_numpy(ctx.R2.astype(np.int32)).to(dev)[:, None].expand(L, B).contiguous()
    xm = mul(ctx, x, r2, mode)
    r = exp(ctx, xm, digits)
    one = torch.zeros((L, B), dtype=torch.int32, device=dev)
    one[0] = 1
    return mul(ctx, r, one, mode).T.contiguous()


# -- one modulus a column (the Sanctum decrypt) -----------------------------


def _check_rowmod(L: int, B: int, device, N32: torch.Tensor, n0inv32: torch.Tensor) -> None:
    W = (L + 1) // 2
    if N32.dim() != 2 or N32.shape[0] != B or N32.shape[1] != W or N32.dtype != torch.int32:
        raise ValueError(f"N32 must be (B={B}, W={W}) int32 words, got "
                         f"{tuple(N32.shape)} {N32.dtype}")
    if n0inv32.dim() != 1 or n0inv32.shape[0] != B or n0inv32.dtype != torch.int32:
        raise ValueError(f"n0inv32 must be (B={B},) int32, got "
                         f"{tuple(n0inv32.shape)} {n0inv32.dtype}")
    for name, x in (("N32", N32), ("n0inv32", n0inv32)):
        if x.device != device:
            raise ValueError(f"device mismatch {device} vs {name} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _plain_rowmod(x: torch.Tensor, L: int) -> torch.Tensor:
    """Limbs-major (L, B) int32 -> batch-major (B, 2W) int64 for the plain
    versions (zero limbs above L)."""
    W = (L + 1) // 2
    out = x.new_zeros((x.shape[1], 2 * W), dtype=torch.int64)
    out[:, :L] = x.T
    return out


def _plain_moduli(N32: torch.Tensor, n0inv32: torch.Tensor) -> tuple:
    """(B, W) int32 words and (B,) -n^-1 mod 2^32 -> the plain versions'
    (B, 2W) int64 16-bit limbs and (B,) -n^-1 mod 2^16."""
    w = N32.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(N32.shape[0], -1)
    return limbs, n0inv32.to(torch.int64) & 0xFFFF


def mul_rowmod_plain(a, b, N32, n0inv32) -> torch.Tensor:
    """The plain version of `mul_rowmod` at its interface, on the
    operands' device (`montgomery._mont_mul_rowmod_raw`)."""
    L = a.shape[0]
    out = montgomery._mont_mul_rowmod_raw(_plain_rowmod(a, L), _plain_rowmod(b, L),
                                          *_plain_moduli(N32, n0inv32))
    return out[:, :L].T.to(torch.int32).contiguous()


def exp_rowmod_plain(base_mont, digits, one_mont, N32, n0inv32) -> torch.Tensor:
    """The plain version of `exp_rowmod` at its interface, on the
    operands' device (`montgomery._mont_exp_rowdigits_raw`)."""
    L = base_mont.shape[0]
    out = montgomery._mont_exp_rowdigits_raw(_plain_rowmod(base_mont, L), digits,
                                             _plain_rowmod(one_mont, L),
                                             *_plain_moduli(N32, n0inv32))
    return out[:, :L].T.to(torch.int32).contiguous()


def mul_rowmod(a: torch.Tensor, b: torch.Tensor, N32: torch.Tensor,
               n0inv32: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod N_i for every column i (`dds_mont_mul_rowmod`,
    the port of `montgomery._mont_mul_rowmod_raw`): a, b limbs-major
    (L, B) int32, column i canonical below N_i (column slices allowed);
    N32 (B, W) int32 words of each column's modulus, W = ceil(L/2);
    n0inv32 (B,) int32 bit patterns of -N_i^-1 mod 2^32. Returns a new
    contiguous (L, B) int32."""
    L = a.shape[0] if a.dim() == 2 else -1
    first = _check(L, a=a, b=b)
    B = first.shape[1]
    _check_rowmod(L, B, first.device, N32, n0inv32)
    if first.device.type == "cpu":
        return mul_rowmod_plain(a, b, N32, n0inv32)
    out = torch.empty((L, B), dtype=torch.int32, device=first.device)
    _launch(ROWMOD, "dds_mont_mul_rowmod", mul_rowmod_launches, first.device,
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), N32.data_ptr(), n0inv32.data_ptr(), L, B,
            what=f"L={L}, B={B}")
    return out


def exp_rowmod(base_mont: torch.Tensor, digits: torch.Tensor, one_mont: torch.Tensor,
               N32: torch.Tensor, n0inv32: torch.Tensor) -> torch.Tensor:
    """base_i^exp_i in column i's Montgomery domain (`dds_mont_exp_rowmod`,
    the port of `montgomery._mont_exp_rowdigits_raw`): base_mont and
    one_mont (R mod N_i) limbs-major (L, B) int32 (column slices allowed);
    digits (E, B) int32 MSB-first 4-bit digits, column i the exponent of
    column i (shorter exponents padded with leading zeros), each taken
    mod 16, column slices allowed; N32 and n0inv32 as for `mul_rowmod`.
    Returns a new contiguous (L, B) int32."""
    L = base_mont.shape[0] if base_mont.dim() == 2 else -1
    first = _check(L, base=base_mont, one_mont=one_mont)
    B = first.shape[1]
    _check_rowmod(L, B, first.device, N32, n0inv32)
    if (digits.dim() != 2 or digits.shape[0] < 1 or digits.shape[1] != B
            or digits.dtype != torch.int32):
        raise ValueError(f"digits must be a non-empty (E, B={B}) int32 tensor, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    if digits.device != first.device:
        raise ValueError(f"device mismatch {first.device} vs {digits.device}")
    if B > 1 and digits.stride(1) != 1:
        raise ValueError("digits columns must be contiguous (stride 1)")
    if first.device.type == "cpu":
        return exp_rowmod_plain(base_mont, digits, one_mont, N32, n0inv32)
    E = digits.shape[0]
    out = torch.empty((L, B), dtype=torch.int32, device=first.device)
    _launch(ROWMOD, "dds_mont_exp_rowmod", exp_rowmod_launches, first.device,
            base_mont.data_ptr(), base_mont.stride(0), out.data_ptr(), out.stride(0),
            digits.data_ptr(), digits.stride(0), E, N32.data_ptr(), n0inv32.data_ptr(),
            one_mont.data_ptr(), one_mont.stride(0), L, B, what=f"L={L}, B={B}, E={E}")
    return out


def rowmod_args(moduli: list[int], L: int, device) -> tuple:
    """(N32, n0inv32, one_mont) for `mul_rowmod` and `exp_rowmod` over the
    odd `moduli`, one a column: (B, W) int32 words, (B,) int32 bit patterns
    of -n^-1 mod 2^32, and the limbs-major (L, B) int32 R mod n, on
    `device`. For public and test moduli: the Sanctum plan builds its
    secret ones per key (`sanctum.device.SecretModCtx`)."""
    W = (L + 1) // 2
    R = 1 << (32 * W)
    words = np.stack([np.frombuffer(n.to_bytes(4 * W, "little"), "<u4") for n in moduli])
    n0 = np.array([(-pow(n, -1, 1 << 32)) % (1 << 32) for n in moduli], np.uint32)
    ones = np.stack([int_to_limbs(R % n, L) for n in moduli]).T
    return (torch.from_numpy(words.view(np.int32).copy()).to(device),
            torch.from_numpy(n0.view(np.int32).copy()).to(device),
            torch.from_numpy(np.ascontiguousarray(ones).view(np.int32)).to(device))
