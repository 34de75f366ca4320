"""The port's device mesh against `dds_tpu.parallel.mesh`, on the CPU.

Twins of `tests/test_parallel.py`'s mesh cases. The reference runs as its
own tests run it: `make_mesh(D)` over the 8 virtual CPU devices of
`tests/conftest.py`, the portable `jnp` kernels (and one `v2` case in
interpret mode). The port runs on `Mesh([cpu] * D)`, its single-process
twin of that fabric, with the kernels' plain PyTorch versions. The same
seeded operands go through both: the fixed sharded fold (both combines,
every port family, D up to 8, non-power-of-two D, K = 1 and K = D - 1),
the raw fold's limbs at even L (the port's R is 2^(32 ceil(L/2)), the
reference's 2^(16 L): they agree only at even L), the sharded modexp, the
backend's mesh branches and DDS_MESH, and a SumAll served through the
port's stack with a mesh. Exact integers, no tolerance.
"""

import asyncio
import json
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dds_tpu.models.backend import TpuBackend
from dds_tpu.ops import bignum as ref_bn
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu.ops.montgomery import _exp_to_digits as ref_digits
from dds_tpu.parallel import make_mesh as ref_make_mesh
from dds_tpu.parallel import mesh as ref_pm
from dds_tpu_torch.models.backend import CudaBackend
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import ModCtx
from dds_tpu_torch.parallel import Mesh, make_mesh, sharded_pow_mod, sharded_reduce_mul
from dds_tpu_torch.parallel import mesh as pm

rng = random.Random(0x3E5)
CPU = torch.device("cpu")
FAMILIES = ("cios", "k1", "fused")


def modulus(bits: int) -> int:
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def pyfold(cs, n):
    acc = 1
    for c in cs:
        acc = acc * c % n
    return acc


def virtual(D: int) -> Mesh:
    return Mesh([CPU] * D)


def port_fixed(n, cs, D, ring=False, kernel="cios"):
    ctx = ModCtx.make(n)
    rows = bn.to_device(bn.ints_to_batch(cs, ctx.L), CPU)
    out = pm.sharded_reduce_mul_fixed(ctx, rows, virtual(D), ring=ring, kernel=kernel)
    assert out.shape == (1, ctx.L) and out.device == CPU
    return bn.limbs_to_int(bn.to_host(out)[0])


def ref_fixed(n, cs, D, ring=False, kernel="jnp"):
    ctx = RefCtx.make(n)
    out = ref_pm.sharded_reduce_mul_fixed(ctx, ref_bn.ints_to_batch(cs, ctx.L),
                                          ref_make_mesh(D), ring=ring, kernel=kernel)
    return ref_bn.limbs_to_int(np.asarray(out)[0])


# --------------------------------------------------------------- the folds


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("K", [8, 16, 37])
def test_sharded_fixed_matches_int_and_the_reference(K, ring):
    """test_parallel.py:23 and :37: K rows over 8 slots, either combine."""
    n = modulus(512)
    cs = [rng.randrange(n) for _ in range(K)]
    want = pyfold(cs, n)
    assert port_fixed(n, cs, 8, ring) == ref_fixed(n, cs, 8, ring) == want


def test_sharded_matches_the_flat_path_bit_exact():
    """test_parallel.py:64: the sharded fold's limbs equal the flat
    `reduce_mul`'s and the reference's sharded and flat folds'."""
    n = modulus(256)
    ctx, rctx = ModCtx.make(n), RefCtx.make(n)
    batch = bn.ints_to_batch([rng.randrange(n) for _ in range(24)], ctx.L)
    rows = bn.to_device(batch, CPU)
    sharded = bn.to_host(pm.sharded_reduce_mul_fixed(ctx, rows, virtual(8)))
    flat = bn.to_host(mont_cuda.reduce_mul(ctx, rows))
    ref_sharded = np.asarray(ref_pm.sharded_reduce_mul_fixed(rctx, batch, ref_make_mesh(8)))
    assert np.array_equal(sharded, flat)
    assert np.array_equal(sharded, ref_sharded)
    assert np.array_equal(sharded, np.asarray(rctx.reduce_mul(batch)))


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("D,K", [(3, 12), (5, 11), (7, 21), (3, 1), (5, 1), (3, 2), (5, 4),
                                 (7, 6), (4, 3), (8, 7), (8, 1)])
def test_non_power_of_two_mesh_and_single_row_shards(D, K, ring):
    """test_parallel.py:75, plus K = 1 and K = D - 1: shards of one row
    (P2 = 1, no local level) and odd tail levels padded with R mod n still
    give prod * R^-(K-1) before the fix."""
    n = modulus(256)
    cs = [rng.randrange(n) for _ in range(K)]
    assert port_fixed(n, cs, D, ring) == ref_fixed(n, cs, D, ring) == pyfold(cs, n)


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_raw_limbs_equal_the_reference_at_even_L(D, ring):
    """The unfixed fold, prod * R^-(K-1) mod n, limb for limb: both
    packages share R = 2^(16 L) at even L (L = 32 here)."""
    n = modulus(512)
    ctx, rctx = ModCtx.make(n), RefCtx.make(n)
    assert ctx.L == rctx.L == 32 and ctx.R == 1 << (16 * ctx.L)
    cs = [rng.randrange(n) for _ in range(19)]
    batch = bn.ints_to_batch(cs, ctx.L)
    port = bn.to_host(sharded_reduce_mul(ctx, bn.to_device(batch, CPU), virtual(D), ring=ring))
    ref = np.asarray(ref_pm.sharded_reduce_mul(rctx, batch, ref_make_mesh(D), ring=ring))
    assert np.array_equal(port, ref)
    R_inv = pow(ctx.R, -1, n)
    assert bn.limbs_to_int(port[0]) == pyfold(cs, n) * pow(R_inv, len(cs) - 1, n) % n


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
def test_odd_L_compares_the_fixed_form(ring):
    """At odd L (33) the two radixes differ, so only the fixed fold, the
    plain-domain product, is compared."""
    n = modulus(520)
    assert ModCtx.make(n).L == RefCtx.make(n).L == 33
    cs = [rng.randrange(n) for _ in range(13)]
    assert port_fixed(n, cs, 4, ring) == ref_fixed(n, cs, 4, ring) == pyfold(cs, n)


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("kernel", FAMILIES)
def test_each_port_family_matches_the_reference_jnp(kernel, ring):
    """test_parallel.py:158 and :186: every shard-local level, the combine
    and the fix in one family (the Karatsuba families' plain versions),
    against the reference's portable kernels."""
    n = modulus(512)
    cs = [rng.randrange(n) for _ in range(21)]
    assert port_fixed(n, cs, 8, ring, kernel) == ref_fixed(n, cs, 8, ring) == pyfold(cs, n)


def test_one_reference_v2_case_in_interpret_mode():
    """test_parallel.py:158's v2 (the reference's default family, Pallas in
    interpret mode) against the port's CIOS family, at L = 32."""
    n = modulus(512)
    cs = [rng.randrange(n) for _ in range(16)]
    assert port_fixed(n, cs, 4) == ref_fixed(n, cs, 4, kernel="v2") == pyfold(cs, n)


@settings(max_examples=6, deadline=None)
@given(K=st.integers(1, 64), D=st.integers(1, 8), ring=st.booleans(),
       seed=st.integers(0, 2**32 - 1))
def test_sharded_fold_is_the_python_product(K, D, ring, seed):
    r = random.Random(seed)
    n = r.getrandbits(256) | (1 << 255) | 1
    cs = [r.randrange(n) for _ in range(K)]
    assert port_fixed(n, cs, D, ring) == pyfold(cs, n)


def test_sharded_launches_follow_the_formula(monkeypatch):
    """One `mont_cuda.mul` a level a slot, then the tail's levels (or the
    ring's D - 1 hops of D multiplies) and the fix: 47 and 57 at K = 8,192,
    D = 4, as chip_smoke.py gates on the card. Every level passes the
    family it was given."""
    calls = []
    real = mont_cuda.mul

    def counting(ctx, a, b, karatsuba=None):
        calls.append(karatsuba)
        return real(ctx, a, b, karatsuba)

    monkeypatch.setattr(mont_cuda, "mul", counting)
    n = modulus(256)
    for K, D, ring, kernel in ((40, 4, False, "cios"), (40, 4, True, "fused"),
                               (11, 3, False, "k1"), (5, 8, True, "cios"), (1, 1, False, "cios")):
        calls.clear()
        cs = [rng.randrange(n) for _ in range(K)]
        assert port_fixed(n, cs, D, ring, kernel) == pyfold(cs, n)
        assert len(calls) == pm.mesh_fold_launches([[-(-K // D)]] * D, ring)
        assert set(calls) == {pm._MODES[kernel]}
    assert pm.mesh_fold_launches([[2048]] * 4) == 47
    assert pm.mesh_fold_launches([[2048]] * 4, ring=True) == 57
    assert pm.mesh_fold_launches([[8192]]) == mont_cuda.fold_launches(8192) == 14


# -------------------------------------------------------------- the modexp


@pytest.mark.parametrize("kernel", FAMILIES)
def test_sharded_pow_mod_matches_int_and_the_reference(kernel):
    """test_parallel.py:53 and :175: 16 bases over 8 slots."""
    n = modulus(256)
    ctx, rctx = ModCtx.make(n), RefCtx.make(n)
    exp = rng.getrandbits(64)
    bases = [rng.randrange(n) for _ in range(16)]
    out = sharded_pow_mod(ctx, bn.to_device(bn.ints_to_batch(bases, ctx.L), CPU), exp,
                          virtual(8), kernel=kernel)
    ref = ref_pm.sharded_pow_mod(rctx, ref_bn.ints_to_batch(bases, rctx.L), ref_digits(exp),
                                 ref_make_mesh(8))
    want = [pow(b, exp, n) for b in bases]
    assert bn.batch_to_ints(bn.to_host(out)) == ref_bn.batch_to_ints(np.asarray(ref)) == want
    flat = mont_cuda.pow_mod(ctx, bn.to_device(bn.ints_to_batch(bases, ctx.L), CPU), exp)
    assert torch.equal(out, flat)


def test_sharded_pow_mod_needs_b_divisible_by_d():
    ctx = ModCtx.make(modulus(256))
    with pytest.raises(ValueError, match="divisible"):
        sharded_pow_mod(ctx, torch.zeros((6, ctx.L), dtype=torch.int32), 3, virtual(4))


def test_an_unknown_family_raises_in_both():
    n = modulus(256)
    ctx, rctx = ModCtx.make(n), RefCtx.make(n)
    rows = bn.to_device(bn.ints_to_batch([3, 5], ctx.L), CPU)
    with pytest.raises(ValueError, match="unknown mesh kernel"):
        sharded_reduce_mul(ctx, rows, virtual(2), kernel="v9")
    with pytest.raises(ValueError, match="unknown mesh kernel"):
        sharded_pow_mod(ctx, rows, 3, virtual(2), kernel="v9")
    with pytest.raises(ValueError, match="unknown mesh kernel"):
        ref_pm.sharded_reduce_mul(rctx, ref_bn.ints_to_batch([3, 5], rctx.L), ref_make_mesh(2),
                                  kernel="v9")
    assert pm.KERNELS == FAMILIES and ref_pm.KERNELS == ("jnp", "v1", "v2")


def test_no_hidden_fallback_when_a_kernel_fails(monkeypatch):
    """A failing product propagates out of the sharded fold and modexp;
    nothing catches it and folds on the host."""
    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(mont_cuda, "mul", broken)
    n = modulus(256)
    ctx = ModCtx.make(n)
    rows = bn.to_device(bn.ints_to_batch([rng.randrange(n) for _ in range(8)], ctx.L), CPU)
    with pytest.raises(RuntimeError, match="launch failed"):
        pm.sharded_reduce_mul_fixed(ctx, rows, virtual(4))
    with pytest.raises(RuntimeError, match="launch failed"):
        sharded_pow_mod(ctx, rows, 5, virtual(4))
    be = CudaBackend(device="cpu", min_device_batch=0, mesh=virtual(4))
    with pytest.raises(RuntimeError, match="launch failed"):
        be.modmul_fold([rng.randrange(n) for _ in range(8)], n)


# ---------------------------------------------------------------- the mesh


def test_mesh_devices_truncation_and_placement():
    """`Mesh` keeps its ordered (repeatable) slots; `make_mesh` truncates
    to distinct devices that exist, as the reference's `devs[:n]`;
    `group_sharding` maps group i to slot i mod D, and answers the
    plane's device without a multi-device mesh."""
    m = virtual(3)
    assert m.size == 3 and m.devices == (CPU,) * 3 and m == virtual(3) != virtual(2)
    assert hash(m) == hash(virtual(3))
    assert make_mesh(4, "cpu") == Mesh([CPU]) and make_mesh(None, "cpu").size == 1
    assert len(ref_make_mesh(4).devices.flat) == 4  # the reference's virtual fabric
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh(["meta"])
    with pytest.raises(ValueError):
        make_mesh(2, "tpu")
    slots = Mesh([CPU] * 3)
    slots._devices = ("d0", "d1", "d2")  # distinguishable stand-ins for three cards
    assert [pm.group_sharding(slots, i, CPU) for i in range(7)] == \
        ["d0", "d1", "d2", "d0", "d1", "d2", "d0"]
    assert pm.group_sharding(None, 5, "cpu") == CPU
    assert pm.group_sharding(Mesh([CPU]), 5, "cpu") == CPU
    assert pm.group_sharding(CPU, 3) == CPU
    assert ref_pm.group_sharding(None, 5) is None and ref_pm.group_sharding(ref_make_mesh(1), 5) is None


def test_a_cuda_slot_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh(["cuda"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


# ------------------------------------------------------------- the backend


def spies(monkeypatch, module):
    seen = []
    orig_reduce, orig_pow = module.sharded_reduce_mul_fixed, module.sharded_pow_mod

    def spy_reduce(*a, **k):
        seen.append(("reduce", k.get("kernel")))
        return orig_reduce(*a, **k)

    def spy_pow(*a, **k):
        seen.append(("pow", k.get("kernel")))
        return orig_pow(*a, **k)

    monkeypatch.setattr(module, "sharded_reduce_mul_fixed", spy_reduce)
    monkeypatch.setattr(module, "sharded_pow_mod", spy_pow)
    return seen


@pytest.mark.parametrize("mode,family", [("0", "cios"), ("1", "k1"), ("2", "fused")])
def test_backend_mesh_dispatches_the_configured_family(monkeypatch, mode, family):
    """test_parallel.py:201: the backend hands its fold family
    (DDS_KARATSUBA, read once a call) to the sharded fold and modexp, as
    the reference's hands `jnp` with Pallas off."""
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    seen, ref_seen = spies(monkeypatch, pm), spies(monkeypatch, ref_pm)
    n = modulus(256)
    cs = [rng.randrange(n) for _ in range(8)]
    bases = [rng.randrange(n) for _ in range(4)]
    be = CudaBackend(device="cpu", min_device_batch=0, mesh=virtual(4))
    ref = TpuBackend(pallas=False, min_device_batch=0, mesh=ref_make_mesh(4))
    assert be.modmul_fold(cs, n) == ref.modmul_fold(cs, n) == pyfold(cs, n)
    assert be.powmod_batch(bases, 65537, n) == ref.powmod_batch(bases, 65537, n) == \
        [pow(b, 65537, n) for b in bases]
    assert seen == [("reduce", family), ("pow", family)]
    assert ref_seen == [("reduce", "jnp"), ("pow", "jnp")]


def test_backend_folds_and_pads_through_the_mesh(monkeypatch):
    """test_parallel.py:240: `reduce_mul_device` (through the store's
    resident fold too) and `powmod_batch` with B % D != 0 (padded with
    base 1, sliced back) go through the mesh, once each."""
    seen, ref_seen = spies(monkeypatch, pm), spies(monkeypatch, ref_pm)
    n = modulus(512)
    cs = [rng.randrange(n) for _ in range(19)]
    bases = [rng.randrange(n) for _ in range(7)]
    be = CudaBackend(device="cpu", min_device_batch=0, mesh=virtual(4))
    ref = TpuBackend(pallas=False, min_device_batch=0, mesh=ref_make_mesh(4))
    assert be.modmul_fold(cs, n) == ref.modmul_fold(cs, n) == pyfold(cs, n)
    assert be.powmod_batch(bases, 65537, n) == ref.powmod_batch(bases, 65537, n) == \
        [pow(b, 65537, n) for b in bases]
    assert be.modmul_fold_resident(cs, n) == pyfold(cs, n)
    assert [k for k, _ in seen] == ["reduce", "pow", "reduce"]
    assert [k for k, _ in ref_seen] == ["reduce", "pow"]


def test_dds_mesh_builds_the_mesh_lazily_and_truncates(monkeypatch):
    """test_parallel.py:274: DDS_MESH=4 builds the mesh at first use. The
    reference's virtual fabric gives 4 devices; the port's `make_mesh`
    truncates to the devices that exist, 1 on the CPU, so the flat path
    runs and the resident plane reports one device."""
    monkeypatch.setenv("DDS_MESH", "4")
    seen = spies(monkeypatch, pm)
    be = CudaBackend(device="cpu", min_device_batch=0)
    ref = TpuBackend(pallas=False, min_device_batch=0)
    assert be.mesh is None and ref.mesh is None  # not built yet
    n = modulus(512)
    cs = [rng.randrange(n) for _ in range(8)]
    assert be.modmul_fold(cs, n) == ref.modmul_fold(cs, n) == pyfold(cs, n)
    assert ref.mesh is not None and ref.mesh.devices.size == 4
    assert be.mesh == Mesh([CPU]) and seen == []
    assert be.resident_plane().stats()["mesh_devices"] == 1
    monkeypatch.setenv("DDS_MESH", "x")
    with pytest.raises(ValueError):
        CudaBackend(device="cpu")


def test_a_sumall_served_through_the_stack_folds_on_the_mesh(monkeypatch):
    """The wiring: the port's 4-replica stack on the CPU with its cuda
    backend (device cpu) given a 4-slot mesh after launch; a SumAll over
    37 PutSet rows takes the sharded fold and equals the Python product."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    seen = spies(monkeypatch, pm)
    n2 = modulus(512)
    vals = [rng.randrange(1, n2) for _ in range(37)]
    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    cfg.proxy.min_device_batch = 0
    cfg.proxy.coalesce_window = 0.0

    async def run():
        dep = await launch(cfg)
        try:
            dep.server.backend.mesh = virtual(4)
            port = dep.server.cfg.port
            for i, v in enumerate(vals):
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": [i, str(v)]}).encode())
                assert status == 200
            status, body = await http_request("127.0.0.1", port, "GET",
                                              f"/SumAll?position=1&nsqr={n2}")
            return dep.server.backend.name, status, int(json.loads(body)["result"])
        finally:
            await dep.stop()

    name, status, result = asyncio.run(asyncio.wait_for(run(), 60))
    assert (name, status) == ("cuda", 200) and result == pyfold(vals, n2)
    assert ("reduce", "cios") in seen
