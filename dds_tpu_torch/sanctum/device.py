"""Sanctum device leg: the fused CRT-Paillier decrypt on the card.

Port of `dds_tpu/sanctum/device.py`:

- **One batch for both legs.** The B ciphertext residues mod p^2 and mod
  q^2 stack into 2B columns of the per-column-modulus kernels
  (`csrc/mont_rowmod.cu` through `ops.mont_cuda.mul_rowmod` /
  `exp_rowmod`), with the fixed exponents p-1 and q-1 pre-decomposed into
  MSB-first window digits: three launches a chunk (entry by R^2, the
  ladder, exit by 1) for two half-width modexps.
- **No secret is ever a compile-time constant.** The kernels are built
  from their source text and flags alone (`ops.mont_cuda.KernelLib`,
  keyed by a hash of both), once for every key; every key-derived value
  (the moduli's words, n0inv, R^2, R mod N, the exponent digits) is a
  runtime kernel argument. So the reference's `compile_cache_bypass`,
  which keeps jit executables with secret constants out of JAX's
  persistent compile cache, has no counterpart here: nothing compiled
  depends on a key.
- **Transient device residency.** The host passes each secret once a
  dispatch as (2, .) arrays; the per-column repeat happens on the device,
  and the device copies are held by nothing after the dispatch. PyTorch's
  caching allocator keeps freed blocks for reuse without clearing them,
  as XLA's does, so secret-derived bytes may stay in device memory until
  another tensor overwrites them. `close()` zero-fills the plan's host
  arrays.

`SecretModCtx` takes its constants from the uncached `ModCtx.build`, never
from `ModCtx.make`, and holds them as the kernels' words.
"""

from __future__ import annotations

import numpy as np
import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits
from dds_tpu_torch.sanctum.plane import _crt_recombine


def _crt_columns(rep: int, N, n0inv, R2, one_mont, digits) -> tuple:
    """Each leg's constants repeated to one column a ciphertext, on their
    device: (N (2 rep, W), n0inv (2 rep,), R2 (L, 2 rep), one_mont
    (L, 2 rep), digits (E, 2 rep)), as the kernels take them."""
    return (N.repeat_interleave(rep, dim=0), n0inv.repeat_interleave(rep),
            R2.T.repeat_interleave(rep, dim=1).contiguous(),
            one_mont.T.repeat_interleave(rep, dim=1).contiguous(),
            digits.repeat_interleave(rep, dim=1).contiguous())


def _fused_crt(bases, N, n0inv, R2, one_mont, digits) -> torch.Tensor:
    """Both CRT legs in one batch: columns [0, B) of the limbs-major
    (L, 2B) int32 `bases` are residues mod p^2, columns [B, 2B) residues
    mod q^2. N: (2, W) int32 words; n0inv: (2,) int32; R2 and one_mont:
    (2, L) int32 limbs; digits: (E, 2) int32, one exponent column a leg.
    The constants are repeated to one column a ciphertext on the device
    (`_crt_columns`), then three launches: into the Montgomery domain
    (`mul_rowmod` by R^2), the ladder (`exp_rowmod`), out of it
    (`mul_rowmod` by 1). Returns the (L, 2B) int32 legs x = c^(p-1) mod
    p^2 and c^(q-1) mod q^2."""
    Nr, n0r, R2r, oner, digr = _crt_columns(bases.shape[1] // 2, N, n0inv, R2, one_mont,
                                            digits)
    base_m = mont_cuda.mul_rowmod(bases, R2r, Nr, n0r)
    r = mont_cuda.exp_rowmod(base_m, digr, oner, Nr, n0r)
    plain_one = torch.zeros_like(bases)
    plain_one[0] = 1
    return mont_cuda.mul_rowmod(r, plain_one, Nr, n0r)


class SecretModCtx:
    """Per-instance Montgomery constants for a SECRET odd modulus: the
    deliberate anti-twin of `ModCtx.make`. Plain construction from the
    uncached `ModCtx.build`, no module-level cache, no device copies of
    its own; `close()` zero-fills the host arrays. N holds the kernels'
    W 32-bit words and n0inv -n^-1 mod 2^32 (as an int32 bit pattern)."""

    def __init__(self, n: int, L: int | None = None):
        ctx = ModCtx.build(n, L)  # uncached; transient, dropped below
        self.L = ctx.L
        self.N = np.frombuffer(n.to_bytes(4 * ctx.W, "little"), "<u4").view(np.int32).copy()
        self.n0inv = np.array([ctx.n0inv32], np.uint32).view(np.int32)
        self.R2 = np.array(ctx.R2, dtype=np.int32)
        self.one_mont = np.array(ctx.one_mont, dtype=np.int32)
        self.closed = False

    def close(self) -> None:
        for arr in (self.N, self.n0inv, self.R2, self.one_mont):
            arr.fill(0)
        self.closed = True


class SecretDevicePlan:
    """Per-key fused CRT decrypt plan (the device opt-in).

    Holds the two `SecretModCtx` legs, the stacked (2, .) constant arrays
    and the exponent digit matrix on the host. A batch goes in chunks of
    `chunk` ciphertexts, each padded to the next power of two with base 1
    (1^e = 1, discarded), one `_fused_crt` call a chunk on `device`."""

    def __init__(self, key, chunk: int = 4096, device="cuda"):
        p, q, n = key.p, key.q, key.n
        hp, hq, qinv = key._crt
        self.p, self.q, self.n = p, q, n
        self.p2, self.q2 = p * p, q * q
        self.hp, self.hq, self.qinv = hp, hq, qinv
        self.chunk = max(1, int(chunk))
        self.device = torch.device(device)
        L = max(bn.n_limbs_for_bits(self.p2.bit_length()),
                bn.n_limbs_for_bits(self.q2.bit_length()))
        self.L = L
        self.ctx_p = SecretModCtx(self.p2, L)
        self.ctx_q = SecretModCtx(self.q2, L)
        self._N = np.stack([self.ctx_p.N, self.ctx_q.N])
        self._n0 = np.concatenate([self.ctx_p.n0inv, self.ctx_q.n0inv])
        self._R2 = np.stack([self.ctx_p.R2, self.ctx_q.R2])
        self._one = np.stack([self.ctx_p.one_mont, self.ctx_q.one_mont])
        dp = _exp_to_digits(p - 1)
        dq = _exp_to_digits(q - 1)
        E = max(len(dp), len(dq))
        digits = np.zeros((E, 2), np.int32)  # leading zeros are no-ops
        digits[E - len(dp):, 0] = dp
        digits[E - len(dq):, 1] = dq
        self._digits = digits
        self.closed = False

    def decrypt_batch(self, cs: list[int]) -> list[int]:
        if self.closed:
            raise RuntimeError("sanctum plan is closed (key scrubbed)")
        out: list[int] = []
        for i in range(0, len(cs), self.chunk):
            out.extend(self._dispatch(cs[i: i + self.chunk]))
        return out

    def _marshal(self, cs: list[int], Bp: int) -> np.ndarray:
        """The (2 Bp, L) uint32 limb rows of one chunk: the residues mod
        p^2, then mod q^2, each padded to Bp rows with 1."""
        pad = [1] * (Bp - len(cs))
        return np.concatenate([
            bn.ints_to_batch([c % self.p2 for c in cs] + pad, self.L),
            bn.ints_to_batch([c % self.q2 for c in cs] + pad, self.L),
        ])

    def _legs(self, bases: np.ndarray, B: int) -> np.ndarray:
        """One chunk's device dispatch: (2 Bp, L) limb rows of B
        ciphertexts in, the legs out as (2 Bp, L) uint32 rows on the
        host."""
        dev = self.device

        def run():
            consts = [torch.from_numpy(a).to(dev)
                      for a in (self._N, self._n0, self._R2, self._one, self._digits)]
            x = bn.to_device(bases, dev).T.contiguous()
            return _fused_crt(x, *consts).T.contiguous()

        return bn.to_host(kprof.profiled("sanctum_crt", run, B=B))

    def _dispatch(self, cs: list[int]) -> list[int]:
        B = len(cs)
        if B == 0:
            return []
        Bp = 1 << max(0, (B - 1).bit_length())
        x = self._legs(self._marshal(cs, Bp), B)
        xps = bn.batch_to_ints(x[:B])
        xqs = bn.batch_to_ints(x[Bp: Bp + B])
        return _crt_recombine(xps, xqs, self.p, self.q, self.n, self.hp, self.hq,
                              self.qinv)

    def close(self) -> None:
        for arr in (self._N, self._n0, self._R2, self._one, self._digits):
            arr.fill(0)
        self.ctx_p.close()
        self.ctx_q.close()
        self.p = self.q = self.n = self.p2 = self.q2 = 0
        self.hp = self.hq = self.qinv = 0
        self.closed = True
