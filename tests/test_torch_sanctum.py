"""The port's Sanctum plane against the reference's, on JAX CPU.

`dds_tpu_torch.sanctum` (the host plan and the device plan on its plain
PyTorch path, `SecretBackend(device="cpu")`) against `dds_tpu.sanctum`,
with 512-bit keys as the reference's tests use and seeded numpy inputs:

- the plain versions of the two kernels of `csrc/mont_rowmod.cu`
  (`montgomery._mont_mul_rowmod_raw`, `_mont_exp_rowdigits_raw`) against
  the reference's XLA functions of the same names, called directly on
  the JAX CPU backend, bit for bit at L = 32 and 64 (where both packages'
  R = 2^(16 L)), with per-row moduli including the carry-edge moduli and
  per-row digit columns of unequal lengths; at odd L = 33 against Python
  ints with the port's own R = 2^(32 W);
- the wrappers `mont_cuda.mul_rowmod` / `exp_rowmod` on CPU tensors, on
  column slices and their argument checks;
- `_fused_crt` against the reference's `_fused_crt_raw` on the same
  stacked inputs, and both plans against the reference's at sizes 1, 3,
  15, 16, 17 and 33 (straddling `min_batch` 16) and at chunk 4;
- the handle's surface, `[crypto] secret-device` validation, key
  hygiene (`cached_moduli`), plan lifetime (gc and `scrub()`), routing
  (public backends refused, `load_provider`, `decrypt_rows`) and the
  reference's secret lint over the port.

Exact integer arithmetic: every comparison is equality. No value derived
from a key's p or q is passed to a call the lint treats as a cache sink.
"""

import gc
import pathlib
import random
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dds_tpu.models.facade import HomoProvider as RefProvider
from dds_tpu.models.keys import HEKeys as RefKeys
from dds_tpu.models.paillier import PaillierKey as RefPaillierKey
from dds_tpu.ops import montgomery as ref_mont
from dds_tpu.sanctum import SecretBackend as RefSecretBackend
from dds_tpu.sanctum import plan_for as ref_plan_for
from dds_tpu.sanctum.device import _fused_crt_raw
from dds_tpu_torch import convert
from dds_tpu_torch.models.backend import CudaBackend, get_backend
from dds_tpu_torch.models.paillier import PaillierKey
from dds_tpu_torch.models.primes import rsa_primes
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda, montgomery
from dds_tpu_torch.sanctum import SecretBackend, is_secret_backend, plan_for
from dds_tpu_torch.sanctum.device import SecretDevicePlan, _fused_crt
from dds_tpu_torch.utils.config import DDSConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
rng = random.Random(0x5A9D)


def _fresh_key(bits: int = 512) -> PaillierKey:
    p, q = rsa_primes(bits)
    return PaillierKey(n=p * q, p=p, q=q)


KEY = _fresh_key()
REF = RefPaillierKey(n=KEY.n, p=KEY.p, q=KEY.q)
CPU = SecretBackend(device="cpu")


def _cts(key, ms):
    pk = key.public
    return [pk.encrypt(m) for m in ms]


# ------------------------------------------------------ plain vs reference


def _row_moduli(L: int, count: int, seed: int) -> list[int]:
    """`count` seeded odd moduli of exactly L 16-bit limbs, then the three
    carry-edge moduli of L limbs."""
    r = np.random.default_rng(seed)
    mods = [int.from_bytes(r.bytes(2 * L), "little") | 1 | (1 << (16 * L - 1))
            for _ in range(count)]
    return mods + montgomery.carry_edge_moduli(L)


def _row_digits(count: int, seed: int) -> np.ndarray:
    """(E, count) uint32 MSB-first digit columns of exponents of unequal
    lengths (1 to 96 bits), shorter ones padded with leading zeros."""
    r = np.random.default_rng(seed)
    exps = [int.from_bytes(r.bytes(int(r.integers(1, 13))), "little") | 1
            for _ in range(count)]
    ds = [montgomery._exp_to_digits(e) for e in exps]
    E = max(len(d) for d in ds)
    out = np.zeros((E, count), np.uint32)
    for i, d in enumerate(ds):
        out[E - len(d):, i] = d
    return out


def _operands(L: int, mods: list[int], seed: int) -> tuple[list[int], list[int]]:
    r = np.random.default_rng(seed)
    a = [int.from_bytes(r.bytes(2 * L), "little") % m for m in mods]
    b = [int.from_bytes(r.bytes(2 * L), "little") % m for m in mods]
    a[0], b[1] = mods[0] - 1, 0  # the largest residue and zero
    return a, b


def _n0(mods: list[int], bits: int) -> list[int]:
    return [(-pow(m, -1, 1 << bits)) % (1 << bits) for m in mods]


def _t64(ints: list[int], L: int) -> torch.Tensor:
    return torch.from_numpy(bn.ints_to_batch(ints, L).astype(np.int64))


def _j(ints: list[int], L: int):
    return jnp.asarray(bn.ints_to_batch(ints, L))


@pytest.mark.parametrize("L", [32, 64])
def test_plain_rowmod_multiply_equals_the_reference(L):
    mods = _row_moduli(L, 9, L)
    a, b = _operands(L, mods, L + 1)
    n0 = _n0(mods, 16)
    want = ref_mont._mont_mul_rowmod_raw(_j(a, L), _j(b, L), _j(mods, L),
                                         jnp.asarray(np.array(n0, np.uint32)))
    got = montgomery._mont_mul_rowmod_raw(_t64(a, L), _t64(b, L), _t64(mods, L),
                                          torch.tensor(n0))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("L", [32, 64])
def test_plain_rowdigits_ladder_equals_the_reference(L):
    mods = _row_moduli(L, 5, 2 * L)
    a, _ = _operands(L, mods, 2 * L + 1)
    R = 1 << (16 * L)
    one = [R % m for m in mods]
    n0 = _n0(mods, 16)
    digits = _row_digits(len(mods), L)
    want = ref_mont._mont_exp_rowdigits_raw(
        _j(a, L), jnp.asarray(digits), _j(one, L), _j(mods, L),
        jnp.asarray(np.array(n0, np.uint32)))
    got = montgomery._mont_exp_rowdigits_raw(_t64(a, L), digits.astype(np.int64),
                                             _t64(one, L), _t64(mods, L), torch.tensor(n0))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_plain_rowmod_at_odd_L_equals_python_with_the_ports_R():
    """At L = 33 the port's R = 2^(32 * 17) is one limb wider than the
    reference's, so the Montgomery-domain values differ by design: the
    plain versions are held against Python ints (a*b*R^-1, and
    x^e * R for x = a R^-1 in the domain)."""
    L, Lp = 33, 34
    mods = _row_moduli(L, 6, 33)
    a, b = _operands(L, mods, 34)
    R = 1 << (16 * Lp)
    n0 = torch.tensor(_n0(mods, 16))
    got = montgomery._mont_mul_rowmod_raw(_t64(a, Lp), _t64(b, Lp), _t64(mods, Lp), n0)
    assert bn.batch_to_ints(got.numpy()) == [x * y * pow(R, -1, m) % m
                                             for x, y, m in zip(a, b, mods)]
    digits = _row_digits(len(mods), 35)
    exps = [int("".join(f"{int(d):x}" for d in digits[:, i]), 16) for i in range(len(mods))]
    got = montgomery._mont_exp_rowdigits_raw(_t64(a, Lp), digits, _t64([R % m for m in mods], Lp),
                                             _t64(mods, Lp), n0)
    assert bn.batch_to_ints(got.numpy()) == [
        pow(x * pow(R, -1, m) % m, e, m) * R % m for x, e, m in zip(a, exps, mods)]


def _words(mods: list[int], L: int) -> torch.Tensor:
    W = (L + 1) // 2
    return torch.from_numpy(np.stack([np.frombuffer(m.to_bytes(4 * W, "little"), "<u4")
                                      for m in mods]).view(np.int32).copy())


def _n032(mods: list[int]) -> torch.Tensor:
    return torch.from_numpy(np.array(_n0(mods, 32), np.uint32).view(np.int32).copy())


@pytest.mark.parametrize("L", [33, 64])
def test_wrappers_on_cpu_tensors_take_the_plain_versions(L):
    """`mul_rowmod` and `exp_rowmod` on limbs-major CPU tensors equal the
    plain versions, also on column slices of a wider array, and launch
    nothing."""
    mods = _row_moduli(L, 5, L + 7)
    a, b = _operands(L, mods, L + 8)
    B, W = len(mods), (L + 1) // 2
    R = 1 << (32 * W)
    A = torch.from_numpy(bn.ints_to_batch(a + a, L).view(np.int32)).T.contiguous()
    Bt = torch.from_numpy(bn.ints_to_batch(b, L).view(np.int32)).T.contiguous()
    one = torch.from_numpy(bn.ints_to_batch([R % m for m in mods], L)
                           .view(np.int32)).T.contiguous()
    N32, n0 = _words(mods, L), _n032(mods)
    digits = torch.from_numpy(_row_digits(2 * B, L).view(np.int32))
    counts = (mont_cuda.mul_rowmod_launches.value, mont_cuda.exp_rowmod_launches.value)
    got = mont_cuda.mul_rowmod(A[:, B:], Bt, N32, n0)
    assert bn.batch_to_ints(bn.to_host(got.T)) == [x * y * pow(R, -1, m) % m
                                                   for x, y, m in zip(a, b, mods)]
    got = mont_cuda.exp_rowmod(A[:, B:], digits[:, B:], one, N32, n0)
    N64, n016 = mont_cuda._plain_moduli(N32, n0)
    assert torch.equal(N64[:, :L], _t64(mods, L)) and n016.tolist() == _n0(mods, 16)
    want = montgomery._mont_exp_rowdigits_raw(
        _t64(a, 2 * W), digits[:, B:].contiguous(), _t64([R % m for m in mods], 2 * W),
        N64, n016)
    assert torch.equal(got, want[:, :L].T.to(torch.int32))
    assert (mont_cuda.mul_rowmod_launches.value, mont_cuda.exp_rowmod_launches.value) == counts


def test_wrapper_argument_checks():
    L, mods = 32, _row_moduli(32, 1, 3)
    x = torch.zeros((L, len(mods)), dtype=torch.int32)
    N32, n0 = _words(mods, L), _n032(mods)
    with pytest.raises(ValueError, match="N32"):
        mont_cuda.mul_rowmod(x, x, N32[:, :-1], n0)
    with pytest.raises(ValueError, match="n0inv32"):
        mont_cuda.mul_rowmod(x, x, N32, n0.to(torch.int64))
    with pytest.raises(ValueError, match="digits"):
        mont_cuda.exp_rowmod(x, torch.zeros((0, len(mods)), dtype=torch.int32), x, N32, n0)
    with pytest.raises(ValueError, match="shape mismatch"):
        mont_cuda.exp_rowmod(x, torch.zeros((2, len(mods)), dtype=torch.int32), x[:, :2],
                             N32, n0)


# ------------------------------------------------------ fused path and plans


def test_fused_crt_equals_the_reference_on_the_same_stacked_inputs():
    """The port's `_fused_crt` (three wrapper calls on the CPU) against
    the reference's un-jitted `_fused_crt_raw`, both fed the same seeded
    stacked bases and their own plan's constants for one key."""
    port = SecretDevicePlan(KEY, device="cpu")
    ref = ref_plan_for(REF, RefSecretBackend(device=True))
    B = 8
    cs = _cts(KEY, [rng.randrange(KEY.n) for _ in range(B - 1)]) + [1]
    bases = port._marshal(cs, B)
    assert np.array_equal(bases, np.concatenate([
        bn.ints_to_batch([c % ref.p2 for c in cs], ref.L),
        bn.ints_to_batch([c % ref.q2 for c in cs], ref.L)]))
    want = np.asarray(_fused_crt_raw(jnp.asarray(bases), jnp.asarray(ref._N),
                                     jnp.asarray(ref._n0), jnp.asarray(ref._R2),
                                     jnp.asarray(ref._one), jnp.asarray(ref._digits)))
    consts = [torch.from_numpy(a) for a in (port._N, port._n0, port._R2, port._one,
                                            port._digits)]
    got = _fused_crt(bn.to_device(bases, "cpu").T.contiguous(), *consts)
    assert np.array_equal(bn.to_host(got.T), want)


@pytest.mark.parametrize("size", [1, 3, 15, 16, 17, 33])
def test_plans_equal_the_reference_straddling_min_batch(size):
    ms = [rng.randrange(KEY.n) for _ in range(size)]
    cts = _cts(KEY, ms)
    ref_dev = RefSecretBackend(device=True)
    want = ref_plan_for(REF, ref_dev).decrypt_batch(cts)
    assert want == ms == ref_plan_for(REF).decrypt_batch(cts)
    assert plan_for(KEY, CPU).decrypt_batch(cts) == want
    assert plan_for(KEY).decrypt_batch(cts) == want
    assert KEY.decrypt_batch(cts, backend=CPU, min_batch=16) == \
        REF.decrypt_batch(cts, backend=ref_dev, min_batch=16) == want
    assert [KEY.decrypt(c) for c in cts] == want


def test_device_plan_chunking_equals_the_reference():
    ms = [rng.randrange(KEY.n) for _ in range(11)]
    cts = _cts(KEY, ms)
    key = PaillierKey(n=KEY.n, p=KEY.p, q=KEY.q)
    plan = plan_for(key, SecretBackend(device="cpu", chunk=4))
    assert plan.chunk == 4
    counts = mont_cuda.mul_rowmod_launches.value
    assert plan.decrypt_batch(cts) == ms
    assert ref_plan_for(REF, RefSecretBackend(device=True, chunk=4)).decrypt_batch(cts) == ms
    assert mont_cuda.mul_rowmod_launches.value == counts  # the CPU launches nothing


# ------------------------------------------------------ surface and flag


def test_secret_backend_surface(monkeypatch):
    assert is_secret_backend(SecretBackend())
    assert is_secret_backend(CPU) and CPU.device == torch.device("cpu")
    assert SecretBackend().device is None and SecretBackend(device=False).device is None
    assert not is_secret_backend(object())
    assert not is_secret_backend(get_backend("cpu"))
    assert not is_secret_backend(CudaBackend(device="cpu"))
    with pytest.raises(ValueError, match="chunk"):
        SecretBackend(chunk=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (True, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SecretBackend(device=dev)


def test_secret_device_flag_validation(monkeypatch):
    """The twin of the reference's flag test, on the port's function: a
    non-boolean config value raises like an unknown environment value."""
    from dds_tpu_torch.ops.flags import secret_device

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    assert secret_device() is False
    assert secret_device(default=True) is True
    with pytest.raises(ValueError, match="secret-device must be a boolean"):
        secret_device(default="yes")            # config typo: loud
    with pytest.raises(ValueError, match="secret-device"):
        secret_device(default=1)
    monkeypatch.setenv("DDS_SECRET_DEVICE", "1")
    assert secret_device(default=False) is True
    monkeypatch.setenv("DDS_SECRET_DEVICE", "off")
    assert secret_device(default=True) is False
    monkeypatch.setenv("DDS_SECRET_DEVICE", "maybe")
    with pytest.raises(ValueError, match="DDS_SECRET_DEVICE"):
        secret_device()


def test_a_non_boolean_secret_device_refuses_to_start(monkeypatch):
    """`[crypto] secret-device = "yes"` parses in both packages; both
    `load_provider`s refuse it instead of reading it as true."""
    from dds_tpu.run import load_provider as ref_load_provider
    from dds_tpu.utils.config import DDSConfig as RefConfig
    from dds_tpu_torch.run import load_provider

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    section = {"crypto": {"secret-device": "yes"},
               "client": {"paillier-bits": 512, "rsa-bits": 512}}
    with pytest.raises(ValueError, match="secret-device must be a boolean"):
        ref_load_provider(RefConfig.from_dict(section))
    with pytest.raises(ValueError, match="secret-device must be a boolean"):
        load_provider(DDSConfig.from_dict({**section, "client": {
            **section["client"], "device": "cpu"}}))


# ------------------------------------------------------ hygiene and lifetime


def test_no_secret_modulus_enters_the_shared_context_cache():
    key = _fresh_key()
    p, q = key.p, key.q
    ms = [rng.randrange(key.n) for _ in range(4)]
    cts = _cts(key, ms)
    before = list(montgomery.cached_moduli())
    assert key.decrypt_batch(cts, backend=CPU, min_batch=1) == ms
    assert key.decrypt_batch(cts) == ms
    after = montgomery.cached_moduli()
    assert after == before
    assert not set(after) & {p, q, p * p, q * q}


def test_dropped_key_leaves_no_reachable_secret_state():
    """Dropping the last reference to a key frees its plans and
    SecretModCtx legs and zero-fills their host arrays through the
    finalizer, without an explicit scrub()."""
    key = _fresh_key()
    ms = [rng.randrange(key.n) for _ in range(2)]
    assert key.decrypt_batch(_cts(key, ms), backend=CPU, min_batch=1) == ms
    assert key.decrypt_batch(_cts(key, ms)) == ms
    plan, host_plan = plan_for(key, CPU), plan_for(key)
    refs = [weakref.ref(o) for o in (plan, plan.ctx_p, plan.ctx_q, host_plan)]
    held = [plan._N, plan._digits, plan._R2, plan.ctx_p.one_mont]
    assert all(a.any() for a in held)
    del key, plan, host_plan
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(a.any() for a in held)


def test_scrub_closes_plans_and_recovers():
    key = _fresh_key()
    ms = [rng.randrange(key.n) for _ in range(3)]
    cts = _cts(key, ms)
    assert key.decrypt_batch(cts, backend=CPU, min_batch=1) == ms
    plan, host = plan_for(key, CPU), plan_for(key)
    key.scrub()
    assert plan.closed and host.closed and not plan._N.any()
    with pytest.raises(RuntimeError, match="scrubbed"):
        plan.decrypt_batch(cts)
    with pytest.raises(RuntimeError, match="scrubbed"):
        host.decrypt_batch(cts)
    assert "_crt" not in key.__dict__
    assert key.decrypt_batch(cts, backend=CPU, min_batch=1) == ms
    assert plan_for(key, CPU) is not plan


# ------------------------------------------------------ routing


def test_public_backends_are_refused():
    cts = _cts(KEY, [1, 2])
    for be in (get_backend("cpu"), CudaBackend(device="cpu")):
        with pytest.raises(ValueError, match="public-parameter"):
            KEY.decrypt_batch(cts, backend=be, min_batch=1)
    with pytest.raises(ValueError, match="public-parameter"):
        KEY.decrypt_batch(cts, backend=object(), min_batch=1)


def test_load_provider_with_secret_device_decrypts_rows_as_the_reference(monkeypatch):
    """`load_provider` with `[crypto] secret-device` hands its provider a
    device-posture Sanctum handle on `[client] device`; `decrypt_rows`
    over PSSE rows equals the reference provider's with its own handle,
    and the device plan served the batch."""
    from dds_tpu_torch.run import load_provider

    monkeypatch.delenv("DDS_SECRET_DEVICE", raising=False)
    ref_keys = RefKeys.generate(512, 512)
    cfg = DDSConfig.from_dict({"crypto": {"secret-device": True}, "client": {
        "device": "cpu", "he-keys-inline": convert.keys_from_reference(ref_keys.to_json())
        .to_json()}})
    provider = load_provider(cfg)
    assert is_secret_backend(provider.secret_backend)
    assert provider.secret_backend.device == torch.device("cpu")
    ref = RefProvider(ref_keys, secret_backend=RefSecretBackend(device=True))
    schema = ["OPE", "PSSE", "PSSE", "None"]
    rows = [[i, -i * 7, i * 11 + 1, f"blob-{i}"] for i in range(10)]
    enc = [ref.encrypt_row(r, 3, schema) for r in rows]
    got = provider.decrypt_rows(enc, 3, schema, min_batch=16)
    assert got == ref.decrypt_rows(enc, 3, schema, min_batch=16) == \
        [[r[0], r[1], r[2], r[3]] for r in rows]
    assert "device:cpu" in provider.keys.psse.__dict__["_sanctum_plans"]


# ------------------------------------------------------ lint


def test_the_reference_secret_lint_is_clean_over_the_port():
    from tools.secret_lint import lint_paths

    violations = lint_paths([ROOT / "dds_tpu_torch", ROOT / "chip_smoke.py"])
    assert violations == [], "\n".join(str(v) for v in violations)
    # the port's own sanctum/ is exempt by its name, as the reference's is
    assert (ROOT / "dds_tpu_torch" / "sanctum" / "device.py").exists()
