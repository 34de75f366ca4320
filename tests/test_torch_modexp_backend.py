"""The port's modexp at a 512-bit modulus and its backends' `powmod_batch`
against the reference's.

The same five-exponent matrix as tests/test_torch_modexp.py, at 512 bits
(kept in its own file so the two halves of the matrix, each several
interpret-mode compiles, run on different test workers); then
`CudaBackend(device="cpu").powmod_batch` against `dds_tpu`'s `CpuBackend`
and `TpuBackend(pallas=True, kernel="v1", min_device_batch=0)` (the B3
Pallas ladder in interpret mode). Exact integer arithmetic: tolerance zero.
"""

import random

import pytest

from dds_tpu.models.backend import CpuBackend as RefCpuBackend
from dds_tpu.models.backend import TpuBackend
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.models.backend import CpuBackend, CudaBackend, get_backend
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.utils.trace import tracer

from test_torch_modexp import EXPS, pow_mod_against_all_references


@pytest.mark.parametrize("exp", EXPS)
def test_pow_mod_matches_all_references_512(exp):
    pow_mod_against_all_references(512, exp)


def test_backend_powmod_batch_matches_reference_backends():
    rng = random.Random(512)
    n = rng.getrandbits(512) | (1 << 511) | 1
    bases = [rng.randrange(1, n) for _ in range(4)] + [n - 1]
    be = CudaBackend(device="cpu")
    tracer.reset()
    got = be.powmod_batch(bases, 65537, n)
    assert got == RefCpuBackend().powmod_batch(bases, 65537, n)
    v1 = TpuBackend(pallas=True, kernel="v1", min_device_batch=0)
    assert got == v1.powmod_batch(bases, 65537, n)
    assert got == CpuBackend().powmod_batch(bases, 65537, n)
    assert [e.meta["b"] for e in tracer.events("kernel.pow.dispatch")] == [5]
    assert len(tracer.events("kernel.pow.execute")) == 1


def test_backend_powmod_batch_reduces_bases_and_takes_edge_cases():
    """Bases at or above the modulus are reduced on the host, as the fold
    does; an empty batch launches nothing."""
    key = bench_paillier_key(512)
    n2 = key.nsquare
    bases = [n2 + 3, 2 * n2 - 1, 0, 1]
    be = get_backend("cuda", device="cpu")
    before = mont_cuda.exp_launches.value
    assert be.powmod_batch([], key.n, n2) == []
    for exp in (0, 1, 2):
        assert be.powmod_batch(bases, exp, n2) == [pow(b, exp, n2) for b in bases]
    assert mont_cuda.exp_launches.value == before  # CPU tensors: no launch

