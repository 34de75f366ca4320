"""The resident plane on a device mesh against `dds_tpu.resident`, on the CPU.

The reference's `ResidentPlane(kernel="jnp", mesh=make_mesh(D))` runs on
the 8 virtual CPU devices of `tests/conftest.py`; the port's
`ResidentPlane(device="cpu", mesh=Mesh([cpu] * D))` on its single-process
twin of that fabric. The port folds each group's rows on the slot that
holds its pool, group i on slot i mod D (`parallel/mesh.mesh_fold`: the
fused tree's local levels on each slot, the tail and the fix on the
first slot), at any S and D; the reference splits the stacked slabs
contiguously when D divides S and folds on one device otherwise. The
product is the same integer.

The reference's plane cannot fold two or more groups on a multi-device
mesh: its pools sit on different devices and its one jitted fold refuses
them ("incompatible devices", ROADMAP §C 16), in either branch. The port
repairs this alone; the twin test keeps showing the reference's
refusal, and the port's folds are held against the reference's
one-device plane and the Python product instead.

The same seeded operands go to both: `fold_groups` for S in {2, 3, 4, 8}
groups of unequal sizes and D in {2, 4}, with their launches; pool
placement, group i on slot i mod D, and each slot folding the rows of
its own pools; `rows_for` handing rows to the
plane's device; `stats()["mesh_devices"]`; the backend's plane taking its
mesh. Exact integers, no tolerance.
"""

import random

import pytest
import torch

from dds_tpu.parallel import make_mesh as ref_make_mesh
from dds_tpu.resident import ResidentPlane as RefPlane
from dds_tpu_torch.models.backend import CudaBackend
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.parallel import Mesh
from dds_tpu_torch.parallel import mesh as pm
from dds_tpu_torch.parallel.mesh import mesh_fold_launches
from dds_tpu_torch.resident import ResidentPlane
from dds_tpu_torch.resident import plane as plane_mod

rng = random.Random(0x5EED)
MODULUS = rng.getrandbits(512) | (1 << 511) | 1  # L = 32
CPU = torch.device("cpu")


def pyfold(cs, n=MODULUS):
    acc = 1
    for c in cs:
        acc = acc * c % n
    return acc


def parts_of(sizes, seed):
    r = random.Random(seed)
    return [(f"s{g}", [r.randrange(1, MODULUS) for _ in range(k)])
            for g, k in enumerate(sizes)]


def counting_mul(monkeypatch):
    calls = []
    real = mont_cuda.mul

    def counting(ctx, a, b, karatsuba=None):
        calls.append(a.shape[1])
        return real(ctx, a, b, karatsuba)

    monkeypatch.setattr(mont_cuda, "mul", counting)
    return calls


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_fold_groups_on_a_mesh_equals_the_reference(monkeypatch, S, D):
    """S groups of unequal sizes over D slots, group g on slot g mod D
    (also where D does not divide S: S = 3, and S = 2 on D = 4), each
    fold equal to the reference's one-device plane and to the Python
    product, with a local tree a slot that holds groups, the tail over
    the S partials and the fix."""
    sizes = [rng.randrange(1, 40) for _ in range(S)]
    parts = parts_of(sizes, 10 * S + D)
    want = pyfold([c for _, ops in parts for c in ops])
    ref = RefPlane(kernel="jnp", initial_rows=8)
    port = ResidentPlane(device="cpu", mesh=Mesh([CPU] * D), initial_rows=8)
    assert ref.fold_groups(parts, MODULUS) == want
    assert port.fold_groups(parts, MODULUS) == want  # ingests on the way
    calls = counting_mul(monkeypatch)
    assert port.fold_groups(parts, MODULUS) == want  # resident rows
    assert len(calls) == mesh_fold_launches([sizes[d::D] for d in range(D)])
    assert port.stats()["mesh_devices"] == D
    assert [p["rows"] for p in port.stats()["pools"]] == \
        [p["rows"] for p in ref.stats()["pools"]]


@pytest.mark.parametrize("S,D", [(2, 2), (3, 2), (4, 4), (8, 4)])
def test_the_references_mesh_plane_refuses_groups_on_several_devices(S, D):
    """ROADMAP §C 16, the reference's behaviour kept: with its pools pinned
    to different mesh devices, its jitted fused fold raises in both
    branches; one group (one device) folds. The port folds the same parts."""
    parts = parts_of([5] * S, 100 + S)
    ref = RefPlane(kernel="jnp", mesh=ref_make_mesh(D), initial_rows=8)
    with pytest.raises(ValueError, match="incompatible devices"):
        ref.fold_groups(parts, MODULUS)
    assert ref.stats()["mesh_devices"] == D
    assert ref.fold_groups(parts[:1], MODULUS) == pyfold(parts[0][1])
    port = ResidentPlane(device="cpu", mesh=Mesh([CPU] * D), initial_rows=8)
    assert port.fold_groups(parts, MODULUS) == pyfold([c for _, o in parts for c in o])


@pytest.mark.parametrize("mode", ["1", "2"])
def test_the_mesh_branch_in_the_karatsuba_families(monkeypatch, mode):
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    parts = parts_of([9, 30, 2, 17], 77)
    port = ResidentPlane(device="cpu", mesh=Mesh([CPU] * 2), initial_rows=8)
    ref = RefPlane(kernel="jnp", initial_rows=8)
    want = pyfold([c for _, ops in parts for c in ops])
    assert port.fold_groups(parts, MODULUS) == ref.fold_groups(parts, MODULUS) == want


def test_mesh_fold_launches_at_the_card_shape(monkeypatch):
    """S = 4 groups of 2,048 at D = 4: 4 x 11 local levels, 2 tail levels
    and the fix, 47 launches, as chip_smoke.py gates on the card (14 on
    the one-device tree; at D = 3 slot 0 holds groups 0 and 3, so 3 x 11
    + 2 + 1); the tail's widths halve from 4."""
    calls = counting_mul(monkeypatch)
    n = random.Random(3).getrandbits(256) | (1 << 255) | 1
    r = random.Random(4)
    parts = [(f"s{g}", [r.randrange(1, n) for _ in range(2048)]) for g in range(4)]
    plane = ResidentPlane(device="cpu", mesh=Mesh([CPU] * 4), max_rows=4096)
    assert plane.fold_groups(parts, n) == pyfold([c for _, o in parts for c in o], n)
    assert mesh_fold_launches([[2048]] * 4) == 47 == len(calls)
    assert calls[-3:] == [2, 1, 1]  # the tail's two levels over 4 partials, the fix
    assert mesh_fold_launches([[2048] * 2] * 2) == 25
    assert mesh_fold_launches([[2048] * 2, [2048], [2048]]) == 36
    assert mesh_fold_launches([[2048] * 4]) == 14


def test_pools_are_placed_round_robin_on_the_slots(monkeypatch):
    """Group i (registration order) lives on slot i mod D:
    `pool()` asks `group_sharding` with the plane's mesh and device."""
    mesh = Mesh([CPU] * 3)
    asked = []
    real = plane_mod.group_sharding

    def spy(m, idx, device=None):
        asked.append((m, idx, device))
        return real(m, idx, device)

    monkeypatch.setattr(plane_mod, "group_sharding", spy)
    plane = ResidentPlane(device="cpu", mesh=mesh)
    plane.register_groups(["a", "b", "c", "d"])
    for gid in ("d", "b", "a"):
        assert plane.pool(gid, MODULUS).device == CPU
    assert asked == [(mesh, 3, CPU), (mesh, 1, CPU), (mesh, 0, CPU)]
    stand_in = Mesh([CPU] * 3)
    stand_in._devices = ("slot0", "slot1", "slot2")
    assert [real(stand_in, i, CPU) for i in (3, 1, 0, 5)] == ["slot0", "slot1", "slot0", "slot2"]


def test_each_slot_folds_the_rows_of_its_own_pools(monkeypatch):
    """`fold_groups` hands `mesh_fold` the rows of group i in slot i mod D,
    in registration order, whatever order the aggregate lists the groups
    in: no group's rows are copied to another slot before its local
    levels run. Groups the aggregate does not touch leave their slot
    empty, and the fold lands on the first slot."""
    seen = []
    real = pm.mesh_fold

    def spy(ctx, slots, home, mode, fix=True):
        seen.append(([[s.shape[0] for s in slabs] for slabs in slots], home))
        return real(ctx, slots, home, mode, fix)

    monkeypatch.setattr(plane_mod, "mesh_fold", spy)
    plane = ResidentPlane(device="cpu", mesh=Mesh([CPU] * 3), initial_rows=8)
    plane.register_groups(["a", "b", "c", "d", "e"])
    parts = [("e", [2, 3]), ("a", [5]), ("d", [7, 11, 13]), ("b", [17, 19, 23, 29])]
    assert plane.fold_groups(parts, MODULUS) == pyfold([2, 3, 5, 7, 11, 13, 17, 19, 23, 29])
    assert seen == [([[1, 3], [2, 4], []], CPU)]  # a, d | e, b | c untouched
    for gid, slot in (("a", 0), ("b", 1), ("d", 0), ("e", 1)):
        assert plane._order[gid] % 3 == slot


def test_rows_for_lands_on_the_planes_device_and_stats_report_the_mesh():
    plane = ResidentPlane(device="cpu", mesh=Mesh([CPU] * 4))
    cs = [rng.randrange(1, MODULUS) for _ in range(5)]
    rows = plane.rows_for("g", MODULUS, cs)
    assert rows.device == CPU and rows.shape == (5, 32)
    assert plane.stats()["mesh_devices"] == 4
    assert ResidentPlane(device="cpu").stats()["mesh_devices"] == 1
    assert RefPlane(kernel="jnp").stats()["mesh_devices"] == 1


def test_the_backends_plane_takes_its_mesh():
    mesh = Mesh([CPU] * 2)
    be = CudaBackend(device="cpu", min_device_batch=0, mesh=mesh)
    plane = be.resident_plane(initial_rows=4, max_rows=64)
    assert plane.mesh is mesh and plane.stats()["mesh_devices"] == 2
    parts = parts_of([3, 6], 5)
    assert plane.fold_groups(parts, MODULUS) == pyfold(parts[0][1] + parts[1][1])
    # a lone group's pool folds through the backend's sharded reduce
    cs = parts[0][1] + parts[1][1]
    assert plane.pool("lone", MODULUS).fold(cs) == pyfold(cs)
