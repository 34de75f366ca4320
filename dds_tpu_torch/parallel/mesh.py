"""The device mesh: sharded folds and modexp over a list of torch devices.

Port of `dds_tpu/parallel/mesh.py`. The reference's mesh is single-
controller SPMD inside the one proxy process: `make_mesh(n)` takes the
first n JAX devices and `shard_map` runs every shard under one caller. The
port keeps that design with a `Mesh` over an ordered list of torch devices
in one process, no process group:

- the K axis (ciphertexts) is split contiguously over the slots, as
  `shard_map`'s `P(axis)` splits it, and each shard is copied to its
  slot's device, so each ciphertext's limb chain stays on one device;
- each slot folds its rows locally with the flat path's kernel family
  (`mont_cuda.mul`, one launch a level on that slot);
- the combine: `ring=False` copies the partials to the first slot and
  runs the reference's log2 tail tree there (the `all_gather`);
  `ring=True` runs D - 1 neighbour hops, each slot multiplying its
  accumulator by the message copied from slot d - 1 (the `ppermute`).

One function, `mesh_fold`, is the fold tree of both the sharded fold and
the resident plane: a slot folds all of its slabs in one segmented tree
(the sharded fold gives each slot one slab, its shard; the plane gives
each slot the pools that live there), the partials meet on the first
slot, and the tail and the fix run there. On one slot it is the plane's
one-device fused tree.

A device may repeat in a mesh: `Mesh([cpu] * 8)` is the port's twin of
the reference's 8 virtual CPU devices, and `Mesh([cuda:0] * D)` runs D
slots on one card. Every copy between slots is an explicit `.to()`, so a
mesh of distinct GPUs moves its rows as the single-card mesh does.

The shard-local math runs the kernels of the flat path, selected by name
(`KERNELS`): "cios" (B1), "k1" and "fused" (the Karatsuba families of
DDS_KARATSUBA). The combine's single-residue multiplies run in the same
family, where the reference keeps its portable `_mont_mul_raw`.

The reference bounds a cache of jitted `shard_map` executables
(`_FN_CACHE`), since each modulus costs an XLA compile; the port compiles
nothing per modulus, so it keeps no such cache.

`combine_partials` is the host modular-product tail over already-reduced
partials, which the sharded proxy's scatter fold, Stratum and Prism's
per-group scatter call.
"""

from __future__ import annotations

import torch

from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx

KERNELS = ("cios", "k1", "fused")
# each family's `karatsuba` argument of `mont_cuda.mul`
_MODES = {"cios": False, "k1": "k1", "fused": "fused"}


class Mesh:
    """An immutable, ordered tuple of torch devices, one a slot. A device
    may repeat (the port's virtual-device fabric). A `cuda` slot without a
    card raises, as `CudaBackend` does; `cuda` without an index is the
    current card."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("Mesh: no CUDA device available (pass cpu "
                                       "devices for the plain PyTorch path)")
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
                elif d.index >= torch.cuda.device_count():
                    raise RuntimeError(f"Mesh: {d} does not exist "
                                       f"({torch.cuda.device_count()} CUDA devices)")
            elif d.type != "cpu":
                raise ValueError(f"Mesh slots are cuda or cpu devices, not {d}")
            devs.append(d)
        if not devs:
            raise ValueError("Mesh needs at least one device")
        self._devices = tuple(devs)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self._devices

    @property
    def size(self) -> int:
        return len(self._devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other._devices == self._devices

    def __hash__(self) -> int:
        return hash(self._devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self._devices]})"


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> Mesh:
    """A mesh over the first `n_devices` distinct devices of `device_type`
    (all of them with None). Like the reference's `devs[:n]` it truncates
    to the devices that exist and never repeats one: on a one-card host
    `make_mesh(4)` is a 1-device mesh, and on the CPU it is `[cpu]`."""
    if device_type == "cpu":
        devs = [torch.device("cpu")]
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device available")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"make_mesh takes cuda or cpu devices, not {device_type!r}")
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)


def _check_kernel(kernel: str) -> str:
    if kernel not in KERNELS:
        raise ValueError(f"unknown mesh kernel {kernel!r} (have {KERNELS})")
    return kernel


def group_sharding(mesh, index: int, device=None) -> torch.device:
    """The device that holds shard group `index`'s resident pool: with a
    multi-device mesh, its slot `index mod D`, round robin. With no mesh,
    or a one-device one, the plane's `device` (the reference answers None,
    default placement); a device passed in place of the mesh stands for a
    one-device mesh on it."""
    if isinstance(mesh, Mesh):
        if mesh.size > 1:
            return mesh.devices[index % mesh.size]
        return torch.device(device) if device is not None else mesh.devices[0]
    return torch.device(device if mesh is None else mesh)


def _local_levels(ctx: ModCtx, slabs: list[torch.Tensor], mode) -> torch.Tensor:
    """One slot's share of the fused tree: its (K_g, L) int32 slabs, all
    on the slot's device, in one limbs-major (L, P2 * G) tensor filled
    with R mod n, column `elem * G + g` holding slab g's element `elem`
    (G slabs, P2 the widest slab's rows rounded up to a power of two);
    log2(P2) levels of one `mont_cuda.mul` each, every slab at once, in
    the family `mode` -> the (L, G) slab partials on that device, no fix."""
    device = slabs[0].device
    L, G = ctx.L, len(slabs)
    P2 = 1 << max(0, (max(s.shape[0] for s in slabs) - 1).bit_length())
    x = torch.empty((L, P2 * G), dtype=torch.int32, device=device)
    x[:] = ctx.consts(device)["one_mont"][:, None]
    cols = x.view(L, P2, G)
    for g, rows in enumerate(slabs):
        cols[:, : rows.shape[0], g] = rows.T
    w = P2 * G
    while w > G:  # elem i with elem i + P2/2, every slab at once
        h = w // 2
        x = mont_cuda.mul(ctx, x[:, :h], x[:, h: 2 * h], mode)
        w = h
    return x


def _tree_reduce_local(ctx: ModCtx, partials: torch.Tensor, mode) -> torch.Tensor:
    """The tail over limbs-major (L, S) partials on one device -> (L, 1):
    each odd level padded with R mod n, one `mont_cuda.mul` a level."""
    t = partials
    one = ctx.consts(t.device)["one_mont"][:, None]
    while t.shape[1] > 1:
        if t.shape[1] % 2:
            t = torch.cat([t, one], dim=1)
        h = t.shape[1] // 2
        t = mont_cuda.mul(ctx, t[:, :h], t[:, h:], mode)
    return t


def mesh_fold(ctx: ModCtx, slots: list[list[torch.Tensor]], home, mode,
              fix: bool = True) -> torch.Tensor:
    """The fused fold over a mesh. `slots` holds, a slot each, the (K_g, L)
    int32 plain-domain slabs that already live on that slot's device (a
    slot may hold none); `home` is the first slot's device. Each slot
    with slabs runs its local levels there (`_local_levels`), its
    partials are copied to `home` (the all_gather), and the tail over all
    S slab partials runs there; with `fix`, one multiply by R^total mod
    n, total the rows of every slab, gives limbs-major (L, 1) = prod mod
    n on `home`; without, prod * R^-(total - 1). One slot is the one-
    device fused tree. `mode` is the product family for every level.

    R-power accounting (structure-independent, the reference's argument):
    `total` real operands plus any number of identity pads through any
    tree shape yield prod * R^-(total - 1)."""
    parts = [_local_levels(ctx, slabs, mode).to(home) for slabs in slots if slabs]
    t = _tree_reduce_local(ctx, torch.cat(parts, dim=1), mode)
    if not fix:
        return t
    total = sum(s.shape[0] for slabs in slots for s in slabs)
    return mont_cuda.mul(ctx, t, ctx.fold_fix(total, home), mode)


def mesh_fold_launches(sizes: list[list[int]], ring: bool = False) -> int:
    """Multiplies of one fixed fold over slots holding slabs of `sizes`
    rows (a list a slot): each slot's log2(P2) local levels, P2 its widest
    slab rounded up to a power of two; then ceil(log2 S) tail levels over
    the S slab partials, or with `ring` D - 1 hops of D multiplies; then
    the fix. Each is one mont_mul launch in mode 0.
    `sharded_reduce_mul_fixed` of K rows over D slots is
    `mesh_fold_launches([[ceil(K / D)]] * D, ring)`."""
    local = sum((max(s) - 1).bit_length() for s in sizes if s)
    combine = (len(sizes) * (len(sizes) - 1) if ring
               else (sum(len(s) for s in sizes) - 1).bit_length())
    return local + combine + 1


def sharded_reduce_mul(ctx: ModCtx, cs: torch.Tensor, mesh: Mesh, ring: bool = False,
                       kernel: str = "cios") -> torch.Tensor:
    """Modular product of K ciphertexts sharded over `mesh`.

    cs: (K, L) int32 plain domain, on any device. Padded to P2 * D rows
    with R mod n, P2 the shard width rounded up to a power of two, and
    split contiguously, P2 rows a slot, each shard copied to its slot;
    returns (1, L) int32 = prod(cs) * R^-(K-1) mod n on the first slot's
    device. Callers fix the R power as `sharded_reduce_mul_fixed` does.
    `kernel` picks the family of every multiply. Both combines take D
    partials through D - 1 Montgomery multiplies, so the result and its R
    accounting are the same:
    - ring=False: `mesh_fold`, one shard a slot, without the fix;
    - ring=True: each slot's local levels, then D - 1 hops; at each,
      every slot d multiplies its accumulator by the message copied from
      slot d - 1 (the reference's `perm = (d, d + 1 mod D)`), then slot
      0's accumulator is returned."""
    mode = _MODES[_check_kernel(kernel)]
    devs = mesh.devices
    D = mesh.size
    K, L = cs.shape
    if K < 1 or L != ctx.L:
        raise ValueError(f"sharded_reduce_mul needs (K >= 1, L={ctx.L}) rows, "
                         f"got {tuple(cs.shape)}")
    P2 = 1 << max(0, (-(-K // D) - 1).bit_length())
    x = torch.empty((P2 * D, L), dtype=torch.int32, device=cs.device)
    x[:K] = cs
    x[K:] = ctx.consts(cs.device)["one_mont"]
    slots = [[x[d * P2: (d + 1) * P2].to(devs[d])] for d in range(D)]
    if not ring:
        return mesh_fold(ctx, slots, devs[0], mode, fix=False).T.contiguous()
    acc = msg = [_local_levels(ctx, slabs, mode) for slabs in slots]
    for _ in range(D - 1):
        msg = [msg[(d - 1) % D].to(devs[d]) for d in range(D)]
        acc = [mont_cuda.mul(ctx, acc[d], msg[d], mode) for d in range(D)]
    return acc[0].T.contiguous()


def sharded_reduce_mul_fixed(ctx: ModCtx, cs: torch.Tensor, mesh: Mesh, ring: bool = False,
                             kernel: str = "cios") -> torch.Tensor:
    """`mont_cuda.reduce_mul`'s contract, mesh-sharded: prod(cs) mod n as
    (1, L) int32 on the first slot's device — `sharded_reduce_mul`, then one
    multiply by R^K mod n there (K the real rows, not the pads)."""
    K = cs.shape[0]
    prod = sharded_reduce_mul(ctx, cs, mesh, ring, kernel)
    fix = ctx.fold_fix(K, prod.device)
    return mont_cuda.mul(ctx, prod.T, fix, _MODES[kernel]).T.contiguous()


def sharded_pow_mod(ctx: ModCtx, bases: torch.Tensor, exp: int, mesh: Mesh,
                    kernel: str = "cios") -> torch.Tensor:
    """Batched modexp with the batch axis sharded over the mesh: (B, L)
    int32 plain-domain bases on any device, B divisible by the mesh's
    size, a shared host-int exponent. Each slot runs `mont_cuda.pow_mod`
    (its two domain multiplies in the family `kernel`, the B3 ladder) on
    its contiguous B/D slice; the outputs are concatenated in order on the
    first slot's device. No collectives."""
    mode = _MODES[_check_kernel(kernel)]
    devs = mesh.devices
    D = mesh.size
    B = bases.shape[0]
    if B % D:
        raise ValueError(f"sharded_pow_mod needs B divisible by the mesh's {D} slots, got B={B}")
    step = B // D
    outs = [mont_cuda.pow_mod(ctx, bases[d * step: (d + 1) * step].to(devs[d]), exp, mode)
            for d in range(D)]
    return torch.cat([o.to(devs[0]) for o in outs], dim=0)


def combine_partials(partials, modulus: int) -> int:
    """Modular-product tail combine over already-reduced partials — the
    host-integer twin of the tail tree the sharded fold runs over gathered
    per-device partials. Every shard group shares one Paillier modulus,
    and the modular product is associative and commutative, so S per-shard
    partials combine bit-for-bit to the single-shard result regardless of
    how the keyspace was partitioned."""
    parts = [p % modulus for p in partials]
    if not parts:
        raise ValueError("combine_partials needs at least one partial")
    while len(parts) > 1:
        nxt = [
            (parts[i] * parts[i + 1]) % modulus
            for i in range(0, len(parts) - 1, 2)
        ]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]
