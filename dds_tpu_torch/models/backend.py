"""Ciphertext-arithmetic backends: `cpu` (python ints) and `cuda`.

Port of `dds_tpu/models/backend.py`, trimmed to the surface the ported
paths use: the aggregate folds, the client's batched modexp and Prism's
weighted folds (`matvec`). The proxy performs its ciphertext math through this
interface using only PUBLIC parameters (Paillier n^2): every modulus
handed to a backend lands in `ModCtx.make`'s process-wide cache, so
secret moduli must never enter.

`CudaBackend` folds K-term aggregates on the device: the content-addressed
resident pool gathers the rows, and `ops/mont_cuda.reduce_mul` runs the
halving tree of Montgomery multiplies plus one R^K fix, in the product
family DDS_KARATSUBA selects (`fold_kernel`; validated at construction).
Folds narrower than `min_device_batch` stay on the host, where a few
Python-int modmuls beat the launch latency of a tree of kernels;
`modmul_fold_many` folds several such requests in one tree
(`ops/foldmany`), for the proxy's coalescer; `resident_plane` builds the
`[resident]` plane on the backend's device. `powmod_batch` runs
one shared-exponent ladder (`ops/mont_cuda.pow_mod`: the exp kernel
between two multiply launches) over the whole batch; its caller decides
when a batch is wide enough (`PaillierPublicKey.blind_batch`'s min_batch).
`matvec` runs one weighted fold (`ops/foldmany.fold_weighted`) when the
request's R x K cells reach `min_device_batch`, the host loop below it.

With a mesh of more than one slot (`mesh=`, or DDS_MESH=N built lazily
at first use by `parallel/mesh.make_mesh`, which truncates to the devices
that exist), `reduce_mul_device` and `powmod_batch` shard their rows over
it (`parallel/mesh.sharded_reduce_mul_fixed`, `sharded_pow_mod`) and the
resident plane places its pools on its slots, as the reference's backend
does. On a one-card host DDS_MESH=N gives a 1-device mesh and the flat
path; `Mesh([dev] * D)` runs D slots on one device.
"""

from __future__ import annotations

import os
import threading
from typing import Protocol

import torch

from dds_tpu_torch.obs import kprof
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import flags, foldmany, mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx

# Host/device crossover for Paillier-2048 folds (modulus n^2, 4096 bits):
# below this many operands the host Python-int fold is faster than a
# resident device fold. Measured by chip_smoke.py's crossover phase on an
# H100 80GB HBM3 at 700 W, three runs: at K=128 the two sides trade
# places (host 7.2 / 5.5 / 7.6 ms vs device 6.4 / 5.8 / 6.6 ms); from
# K=256 the device wins in all three (host 17.0 / 11.0 / 12.2 ms vs device
# 7.7 / 6.5 / 6.7 ms). PERF.md.
MIN_DEVICE_BATCH = 256


class CryptoBackend(Protocol):
    """Ciphertext-domain modular arithmetic over PUBLIC parameters only."""

    name: str

    def modmul(self, c1: int, c2: int, modulus: int) -> int: ...

    def modmul_fold(self, cs: list[int], modulus: int) -> int: ...

    def powmod_batch(self, bases: list[int], exp: int, modulus: int) -> list[int]: ...

    def matvec(self, cs: list[int], weights: list[list[int]], modulus: int,
               rows: object = None) -> list[int]: ...


def _host_fold(cs: list[int], modulus: int) -> int:
    acc = 1
    for c in cs:
        acc = acc * c % modulus
    return acc


def _host_matvec(cs: list[int], weights: list[list[int]], modulus: int) -> list[int]:
    """Per-row weighted fold on host ints: out[r] = prod_k cs[k]^w[r][k]
    mod modulus, skipping zero weights (GroupBySum's selector rows are
    mostly zeros). The below-crossover path of every backend; the
    reference runs it on its C++ host bignum, which is not ported, so
    this is Python's `pow` (the same values)."""
    out = []
    for row in weights:
        acc = 1
        for c, w in zip(cs, row):
            if w:
                acc = acc * pow(c, w, modulus) % modulus
        out.append(acc)
    return out


class CpuBackend:
    """Python-int reference backend (the CPU baseline). It has no
    `modmul_fold_many`, as in the reference, so its proxy never
    coalesces."""

    name = "cpu"

    def modmul(self, c1: int, c2: int, modulus: int) -> int:
        return c1 * c2 % modulus

    def modmul_fold(self, cs: list[int], modulus: int) -> int:
        return _host_fold(cs, modulus)

    def powmod_batch(self, bases: list[int], exp: int, modulus: int) -> list[int]:
        return [pow(b, exp, modulus) for b in bases]

    def matvec(self, cs: list[int], weights: list[list[int]], modulus: int,
               rows: object = None) -> list[int]:
        # `rows` (operands gathered on the device) serves the device path
        # only; the host loop works from the ints
        return _host_matvec(cs, weights, modulus)


class CudaBackend:
    """Device folds on the Hopper Montgomery-multiply kernel.

    `device` is where pools live and folds run: "cuda" (the default) needs
    a CUDA device and raises without one; "cpu" runs the same code path on
    the plain PyTorch Montgomery product (the tests use it)."""

    name = "cuda"

    def __init__(self, device: str | torch.device = "cuda",
                 min_device_batch: int | None = None, mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBackend: no CUDA device available (pass device='cpu' "
                "for the plain PyTorch path)"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"CudaBackend runs on cuda or cpu, not {self.device}")
        # a bogus DDS_KARATSUBA fails here, not inside the first fold
        flags.karatsuba_mode()
        self.min_device_batch = (
            MIN_DEVICE_BATCH if min_device_batch is None else min_device_batch
        )
        # the device mesh (`parallel/mesh.Mesh`): pass mesh= explicitly, or
        # set DDS_MESH=N to build an N-device mesh lazily at first use
        self.mesh = mesh
        self._mesh_n = int(os.environ.get("DDS_MESH", "0")) if mesh is None else 0
        self._stores: dict[int, object] = {}
        self._stores_lock = threading.Lock()  # folds run on proxy threads

    def store_for(self, modulus: int):
        """Per-modulus device-resident cipher store (ops/store.py)."""
        with self._stores_lock:
            store = self._stores.get(modulus)
            if store is None:
                from dds_tpu_torch.ops.store import DeviceCipherStore

                ctx = ModCtx.make(modulus)
                store = DeviceCipherStore(
                    modulus,
                    reduce=lambda rows: self.reduce_mul_device(ctx, rows),
                    device=self.device,
                )
                self._stores[modulus] = store
            return store

    def modmul_fold_resident(self, cs: list[int], modulus: int) -> int:
        """Fold via the device store: unseen ciphertexts ingest once, the
        aggregate gathers resident rows on the device. Folds narrower than
        min_device_batch run on the host."""
        if len(cs) < self.min_device_batch:
            return _host_fold(cs, modulus)
        return self.store_for(modulus).fold(cs)

    def modmul(self, c1: int, c2: int, modulus: int) -> int:
        # one multiply: a device round-trip can never win
        return c1 * c2 % modulus

    def fold_kernel(self) -> str:
        """The Montgomery-multiply family folds run on now: "cios" (the
        default), "k1" or "fused" — DDS_KARATSUBA, read at every fold."""
        return flags.karatsuba_mode() or "cios"

    def resident_plane(self, initial_rows: int = 256, max_rows: int = 1 << 20):
        """A `ResidentPlane` on this backend's device and mesh whose pools
        fold through `reduce_mul_device`, so lone-group resident folds run
        the kernels of the flat path (the twin of
        `TpuBackend.resident_plane`)."""
        from dds_tpu_torch.resident import ResidentPlane

        def reduce_factory(modulus: int):
            ctx = ModCtx.make(modulus)
            return lambda rows: self.reduce_mul_device(ctx, rows)

        return ResidentPlane(device=self.device, mesh=self._get_mesh(),
                             initial_rows=initial_rows, max_rows=max_rows,
                             reduce_factory=reduce_factory)

    def _get_mesh(self):
        if self.mesh is None and self._mesh_n > 1:
            from dds_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(self._mesh_n, self.device.type)
            self._mesh_n = 0
        return self.mesh

    def reduce_mul_device(self, ctx: ModCtx, batch: torch.Tensor) -> torch.Tensor:
        """Modular product over a (K, L) limb batch already on the device:
        the one fold entry point shared by the store and modmul_fold;
        sharded over the mesh when it has more than one slot, in the
        family `fold_kernel` reads once for the fold."""
        mesh = self._get_mesh()
        if mesh is not None and mesh.size > 1:
            from dds_tpu_torch.parallel import mesh as pm

            return pm.sharded_reduce_mul_fixed(ctx, batch, mesh, kernel=self.fold_kernel())
        return mont_cuda.reduce_mul(ctx, batch)

    def modmul_fold(self, cs: list[int], modulus: int) -> int:
        if len(cs) < self.min_device_batch:
            return _host_fold(cs, modulus)
        ctx = ModCtx.make(modulus)
        batch = bn.to_device(bn.ints_to_batch([c % modulus for c in cs], ctx.L),
                             self.device)
        out = self.reduce_mul_device(ctx, batch)
        return bn.limbs_to_int(bn.to_host(out)[0])

    def modmul_fold_many(self, folds: list[list[int]], modulus: int) -> list[int]:
        """Fold R requests' operand lists in one device pass
        (`ops/foldmany.fold_many`): the cross-request batching for
        concurrent small aggregates that each sit below min_device_batch."""
        return foldmany.fold_many(folds, modulus, device=self.device)

    def matvec(self, cs: list[int], weights: list[list[int]], modulus: int,
               rows: torch.Tensor | None = None) -> list[int]:
        """Plaintext-matrix x ciphertext-vector products (Prism): one
        weighted fold on the device (`ops/foldmany.fold_weighted`) when the
        R x K cell count reaches min_device_batch, the host loop below it,
        where launch latency beats the math as for small aggregates.
        `rows` optionally gives the operands as (K, L) limbs already
        gathered on the device from a resident pool."""
        if len(weights) * len(cs) < self.min_device_batch:
            return _host_matvec(cs, weights, modulus)
        return foldmany.fold_weighted(cs, weights, modulus, device=self.device, rows=rows)

    def powmod_batch(self, bases: list[int], exp: int, modulus: int) -> list[int]:
        """[b^exp mod modulus for b in bases] in one `mont_cuda.pow_mod`,
        with `kernel.pow.{dispatch,execute}` spans. Bases are reduced mod
        the modulus on the host first. The dispatch span includes the copy
        to the device, which waits for work other threads queued earlier
        on the stream. With a mesh of more than one slot the batch is
        padded with base 1 (1^e = 1) to a multiple of its size and
        sharded over it (`sharded_pow_mod`), the result sliced back."""
        if not bases:
            return []
        ctx = ModCtx.make(modulus)
        B = len(bases)
        mesh = self._get_mesh()
        D = mesh.size if mesh is not None else 1
        rows = bn.ints_to_batch([b % modulus for b in bases] + [1] * (-B % D), ctx.L)
        if D > 1:
            from dds_tpu_torch.parallel import mesh as pm

            kernel = self.fold_kernel()
            run = lambda: pm.sharded_pow_mod(  # noqa: E731
                ctx, bn.to_device(rows, self.device), exp, mesh, kernel=kernel)
        else:
            run = lambda: mont_cuda.pow_mod(ctx, bn.to_device(rows, self.device), exp)  # noqa: E731
        out = kprof.profiled("pow", run, b=B, e_bits=exp.bit_length())
        return bn.batch_to_ints(bn.to_host(out[:B]))


_BACKENDS = {"cpu": CpuBackend, "cuda": CudaBackend}


def get_backend(name: str, **kwargs) -> CryptoBackend:
    """Backend by name; `kwargs` reach the constructor (the cuda
    backend's `device`, `min_device_batch` and `mesh`)."""
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown crypto backend {name!r} (have {sorted(_BACKENDS)})")
    return cls(**kwargs)
