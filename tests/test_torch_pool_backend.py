"""The port's resident pool, backends and state carry-over, on the CPU.

`dds_tpu_torch.resident.pool.ResidentPool` growth / reset / epoch / memo
behaviour and a reset-vs-fold thread race; `CudaBackend(device="cpu")`
against `dds_tpu`'s `CpuBackend`; `convert.py` round trips from the
reference's constants and pool rows; `CudaBackend()` refusing to start
without a CUDA device. Exact integer arithmetic: tolerance zero.
"""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from dds_tpu.models.backend import CpuBackend as RefCpuBackend
from dds_tpu.ops.montgomery import ModCtx as RefCtx
from dds_tpu.ops.store import DeviceCipherStore as RefStore
from dds_tpu_torch import convert
from dds_tpu_torch.models.backend import CpuBackend, CudaBackend, get_backend
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.resident.pool import ResidentPool

# a 512-bit Paillier modulus squared: the fold modulus n^2 (1024 bits)
_P = 0xECF4AF2EB2403D84A99531A6A8F4015B49BC0A2AE6BAFCD409225E9676345113
_Q = 0xDAE3DC3EB4A6D0C1BC40B874E4313E0C1B68689358E88A8B11A3E6BF4542FAAB
N2 = (_P * _Q) ** 2


def _ciphers(seed, count, mod=N2):
    rng = random.Random(seed)
    return [rng.randrange(1, mod) for _ in range(count)]


def _prod(cs, mod=N2):
    acc = 1
    for c in cs:
        acc = acc * c % mod
    return acc


def test_pool_grows_by_doubling_and_memoizes_row_indices():
    pool = ResidentPool(N2, initial_rows=4, device="cpu")
    cs = _ciphers(1, 10)
    assert pool.ingest(cs) == 10
    assert (pool.resident, pool.capacity, pool.epoch) == (10, 16, 0)
    assert pool.ingest(cs[:3]) == 0  # content-addressed: no re-ingest
    assert pool.fold(cs) == _prod(cs)
    assert pool._idx_memo[0] is cs
    assert pool.fold(cs) == _prod(cs)  # memo hit: same list object
    assert pool.hit_ratio() == 1.0
    more = cs + _ciphers(2, 3)  # 3 unseen operands ingest on the fold path
    assert pool.fold(more) == _prod(more)
    assert pool.resident == 13
    assert pool.hit_ratio() == 30 / 33


def test_pool_reset_bumps_epoch_and_invalidates_memo():
    pool = ResidentPool(N2, initial_rows=4, max_rows=8, device="cpu")
    first = _ciphers(3, 6)
    assert pool.fold(first) == _prod(first)
    second = _ciphers(4, 5)  # 6 + 5 > max_rows: reset, re-ingest on demand
    assert pool.fold(second) == _prod(second)
    assert (pool.epoch, pool.resets, pool.resident) == (1, 1, 5)
    # the memo of `first` was taken at epoch 0: folding it again must
    # re-resolve rows, not gather stale indices
    assert pool.fold(first) == _prod(first)
    assert pool.epoch == 2
    wide = _ciphers(5, 9)  # wider than max_rows: direct fold, still exact
    assert pool.fold(wide) == _prod(wide)
    assert pool.fold([]) == 1


def test_pool_reset_racing_folds_never_gathers_wrong_rows():
    """Folds on worker threads race resets that reuse row indices: every
    fold must still see exactly its own ciphertexts."""
    n = _P * _Q  # 512-bit modulus: the race, not the width, is under test
    pool = ResidentPool(n, initial_rows=4, max_rows=8, device="cpu")
    sets = [_ciphers(10 + i, 5, n) for i in range(6)]
    want = [_prod(s, n) for s in sets]
    errors = []

    def worker(i):
        try:
            for r in range(3):
                j = (i + r) % len(sets)
                got = pool.fold(sets[j])
                if got != want[j]:
                    errors.append((j, r))
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert pool.resets > 0  # the race really crossed resets


def test_cuda_backend_on_cpu_matches_reference_cpu_backend():
    ref, port = RefCpuBackend(), CudaBackend(device="cpu", min_device_batch=0)
    assert port.name == "cuda" and port.device.type == "cpu"
    cs = _ciphers(20, 37)
    want = ref.modmul_fold(cs, N2)
    assert port.modmul_fold(cs, N2) == want
    assert port.modmul_fold_resident(cs, N2) == want
    assert port.modmul_fold_resident(cs, N2) == want  # resident rows, memo
    assert port.store_for(N2) is port.store_for(N2)
    assert port.store_for(N2).resident == 37
    assert port.modmul(cs[0], cs[1], N2) == ref.modmul(cs[0], cs[1], N2)
    assert CpuBackend().modmul_fold(cs, N2) == want
    # below the crossover the fold stays on the host: no pool is touched
    host = CudaBackend(device="cpu", min_device_batch=64)
    assert host.modmul_fold_resident(cs, N2) == want
    assert host._stores == {}
    assert get_backend("cuda", device="cpu").name == "cuda"
    with pytest.raises(ValueError):
        get_backend("tpu")


def test_cuda_backend_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        CudaBackend()
    with pytest.raises(RuntimeError):
        get_backend("cuda")
    with pytest.raises(ValueError):
        CudaBackend(device="meta")
    CudaBackend(device="cpu")  # the plain path needs no card


def test_ctx_from_numpy_checks_reference_constants():
    for bits in (1024, 520):
        n = random.Random(bits).getrandbits(bits) | (1 << (bits - 1)) | 1
        ref = RefCtx.make(n)
        ctx = convert.ctx_from_numpy(n, ref.N, ref.R2, ref.one_mont, ref.n0inv)
        np.testing.assert_array_equal(ctx.N, ref.N)
        if ctx.L % 2 == 0:
            np.testing.assert_array_equal(ctx.R2, ref.R2)
        bad = np.array(ref.R2, copy=True)
        bad[0] ^= 1
        with pytest.raises(ValueError):
            convert.ctx_from_numpy(n, ref.N, bad, ref.one_mont, ref.n0inv)
        with pytest.raises(ValueError):
            convert.ctx_from_numpy(n, ref.N, ref.R2, ref.one_mont, int(ref.n0inv) ^ 1)


def test_pool_carried_across_folds_like_the_reference_pool():
    cs = _ciphers(30, 24)
    ref = RefStore(N2)
    want = ref.fold(cs)
    rows = np.asarray(ref._buf[: ref.resident])
    ciphers = sorted(ref._index, key=ref._index.get)  # row order
    pool = convert.pool_from_numpy(N2, ciphers, rows, device="cpu")
    assert pool.resident == 24 and pool._index == ref._index
    assert pool.fold(cs) == want == _prod(cs)
    assert pool.hit_ratio() == 1.0  # every operand came over resident
    with pytest.raises(ValueError):
        convert.pool_from_numpy(N2, ciphers[::-1], rows, device="cpu")
    with pytest.raises(ValueError):
        convert.pool_from_numpy(N2, ciphers, rows[:, :-1], device="cpu")


def test_pool_default_reduce_is_the_kernel_wrapper():
    pool = ResidentPool(N2, device="cpu")
    cs = _ciphers(40, 3)
    before = mont_cuda.launches.value
    assert pool.fold(cs) == _prod(cs)
    assert mont_cuda.launches.value == before  # CPU tensors: plain path, no launch
