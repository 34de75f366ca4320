"""The port's `TenantKeyring` against the reference's, exactly.

Key families cross by `convert.keyring_to_reference` /
`keyring_from_reference` (each epoch as `(version, HEKeys JSON,
created_at, grace_until)`, plus the shredded tenants). Generation is the
one random step of the lifecycle, so both keyrings here draw their new
epochs from one pool of reference-generated Paillier-512 / RSA-512
families, carried into each package as JSON; everything else — lazy
onboarding and the pending event, distinct moduli and HMAC secrets,
rotation with its grace window on one fake clock, re-encrypt-on-read,
the terminal and idempotent shred, the capacity refusal, stats, gauges
and counters — must give equal observations in both packages, exact
integers as the tolerance. The scrub race runs in both; the residue
check and the converter's validation run on the port.
"""

import gc
import importlib
import json
import threading
import weakref

import numpy as np
import pytest

from dds_tpu_torch import convert

BITS = 512


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def pool():
    """Eight reference key families as HEKeys JSON: the epochs both
    packages' keyrings mint, in order."""
    HEKeys = mod("dds_tpu", "models.keys").HEKeys
    return [HEKeys.generate(BITS, BITS).to_json() for _ in range(8)]


def keyring(pkg: str, pool: list[str], clock, **kw):
    """A keyring of `pkg` whose generation takes the next family of `pool`."""
    ten = mod(pkg, "models.tenancy")
    HEKeys = mod(pkg, "models.keys").HEKeys
    kr = ten.TenantKeyring(paillier_bits=BITS, rsa_bits=BITS, clock=clock, **kw)
    families = iter(pool)
    kr._generate = lambda version: ten.KeyEpoch(version, HEKeys.from_json(next(families)),
                                                clock())
    return kr


def twin(scenario, pool):
    """`scenario(pkg, keyring_factory, clock)` on both packages, each on
    its own fake clock started at the same instant; equal results."""
    out = []
    for pkg in ("dds_tpu", "dds_tpu_torch"):
        clk = FakeClock()
        out.append(scenario(pkg, lambda **kw: keyring(pkg, pool, clk, **kw), clk))
    assert out[1] == out[0]
    return out[1]


def outcome(fn):
    """fn()'s value, or the exception's type name and message."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the observation
        return type(e).__name__, str(e)


def seeded_ms(n: int, seed: int) -> list[int]:
    return [int(x) for x in np.random.default_rng(seed).integers(0, 1 << 40, n)]


def test_lazy_onboarding_distinct_moduli_and_hmac_twin(pool):
    ms = seeded_ms(4, 1511)

    def scenario(pkg, make, clk):
        kr = make()
        ct, ver = kr.encrypt("acme", ms[0])
        ns = [kr.keys_for(t).psse.n for t in ("acme", "beta")]
        return (ver, kr.version("acme"), kr.decrypt("acme", ct, ver), kr.known("acme"),
                kr.known("ghost"), outcome(lambda: kr._domain("ghost", create=False)),
                ns, ns[0] != ns[1], kr.hmac_secret("acme").hex(),
                kr.hmac_secret("acme") != kr.hmac_secret("beta"), kr.stats())

    out = twin(scenario, pool)
    assert out[:5] == (1, 1, ms[0], True, False)
    assert out[5] == ("TenantKeyError", "\"unknown tenant 'ghost'\"")
    assert out[7] and out[9]


def test_rotation_grace_and_reencrypt_on_read_twin(pool):
    ms = seeded_ms(2, 1512)

    def scenario(pkg, make, clk):
        metrics = mod(pkg, "obs.metrics").metrics
        before = metrics.value("dds_tenant_rotations_total", tenant="acme") or 0
        kr = make(grace=60.0)
        ct1, v1 = kr.encrypt("acme", ms[0])
        h1 = kr.hmac_secret("acme")
        out = [kr.rotate("acme"), kr.decrypt("acme", ct1, v1)]
        ct2, v2, migrated = kr.reencrypt("acme", ct1, v1)
        out += [v2, migrated, kr.decrypt("acme", ct2, v2)]
        same, ver, moved = kr.reencrypt("acme", ct2, v2)
        out += [same == ct2, ver, moved, h1 != kr.hmac_secret("acme"),
                [e.version for e in kr.epochs_for("acme")], kr.stats()]
        clk.advance(61.0)
        out += [outcome(lambda: kr.decrypt("acme", ct1, v1)), kr.decrypt("acme", ct2, v2),
                [e.version for e in kr.epochs_for("acme")], kr.stats(),
                (metrics.value("dds_tenant_rotations_total", tenant="acme") or 0) - before]
        return out

    out = twin(scenario, pool)
    assert out[:10] == [2, ms[0], 2, True, ms[0], True, 2, False, True, [2, 1]]
    assert out[11][0] == "TenantKeyError" and "not live" in out[11][1]
    assert out[12:14] == [ms[0], [2]] and out[15] == 1


def test_shred_is_terminal_typed_and_idempotent_twin(pool):
    ms = seeded_ms(2, 1513)

    def scenario(pkg, make, clk):
        metrics = mod(pkg, "obs.metrics").metrics
        before = metrics.value("dds_tenant_shreds_total") or 0
        kr = make()
        ct, ver = kr.encrypt("acme", ms[0])
        kr.rotate("acme")
        out = [kr.shred("acme")]
        for op in (lambda: kr.keys_for("acme"), lambda: kr.decrypt("acme", ct, ver),
                   lambda: kr.encrypt("acme", 1), lambda: kr.rotate("acme"),
                   lambda: kr.hmac_secret("acme"), lambda: kr.epochs_for("acme")):
            out.append(outcome(op))
        out += [kr.is_shredded("acme"), kr.known("acme"), kr.shred("acme"),
                kr.decrypt("b", kr.encrypt("b", ms[1])[0]), kr.stats(),
                (metrics.value("dds_tenant_shreds_total") or 0) - before]
        reg = mod(pkg, "obs.metrics").Registry()
        kr.export_gauges(reg)
        out.append(reg.render())
        return out

    out = twin(scenario, pool)
    assert out[0] == {"tenant": "acme", "already": False, "epochs_scrubbed": 2}
    shredded = ("TenantShredded", "\"tenant 'acme' crypto domain has been shredded\"")
    assert out[1:7] == [shredded] * 6
    assert out[7:11] == [True, False, {"tenant": "acme", "already": True,
                                       "epochs_scrubbed": 0}, ms[1]]
    assert out[11]["shredded"] == 1 and out[11]["tenants"] == 2 and out[12] == 1
    assert "dds_tenant_domains 2" in out[13] and "dds_tenant_domains_shredded 1" in out[13]


def test_capacity_is_a_typed_refusal_twin(pool):
    def scenario(pkg, make, clk):
        kr = make(max_tenants=2)
        kr.keys_for("a")
        kr.keys_for("b")
        return outcome(lambda: kr.keys_for("c")), kr.keys_for("a").psse.n, kr.stats()["tenants"]

    out = twin(scenario, pool)
    assert out[0][0] == "TenantKeyError" and "full" in out[0][1] and out[2] == 2


def test_pending_event_makes_concurrent_first_touches_generate_once_twin(pool):
    def scenario(pkg, make, clk):
        kr = make()
        gate, calls = threading.Event(), []
        inner = kr._generate

        def slow(version):
            calls.append(version)
            gate.wait(10)
            return inner(version)

        kr._generate = slow
        got = []
        threads = [threading.Thread(target=lambda: got.append(kr.keys_for("acme").psse.n))
                   for _ in range(4)]
        for t in threads:
            t.start()
        while not calls:
            threading.Event().wait(0.001)
        gate.set()
        for t in threads:
            t.join(10)
        return calls, len(set(got)), len(got)

    assert twin(scenario, pool) == ([1], 1, 4)


def test_scrub_race_rotation_and_shred_against_decrypts_twin(pool):
    """Rotation and shred race decrypts on worker threads: every decrypt
    returns the plaintext or a typed refusal, never garbage; afterwards
    the shredded tenant is refused and the control tenant works. The
    interleaving differs run to run, so the twins compare what is
    decided: the terminal state."""
    ms = seeded_ms(2, 1514)

    def scenario(pkg, make, clk):
        ten = mod(pkg, "models.tenancy")
        kr = make(grace=60.0)
        ct, ver = kr.encrypt("victim", ms[0])
        cct, cver = kr.encrypt("control", ms[1])
        stop, outcomes, errors = threading.Event(), [], []

        def churn():
            while not stop.is_set():
                try:
                    got = kr.decrypt("victim", ct, ver)
                    if got != ms[0]:
                        errors.append(f"garbage decrypt {got}")
                        return
                    outcomes.append("ok")
                except (ten.TenantShredded, ten.TenantKeyError):
                    outcomes.append("refused")
                except BaseException as e:  # noqa: BLE001 - the assertion
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=churn) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            versions = [kr.rotate("victim") for _ in range(3)]
            summary = kr.shred("victim")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        return (errors, bool(outcomes), versions, summary,
                outcome(lambda: kr.decrypt("victim", ct, ver))[0],
                kr.decrypt("control", cct, cver))

    out = twin(scenario, pool)
    assert out == ([], True, [2, 3, 4],
                   {"tenant": "victim", "already": False, "epochs_scrubbed": 4},
                   "TenantShredded", ms[1])


def test_shred_leaves_no_reachable_key_state():
    """After shred(), no strong reference to the tenant's PaillierKey or
    its HEKeys survives inside the port's keyring: gc reclaims them."""
    kr = mod("dds_tpu_torch", "models.tenancy").TenantKeyring(BITS, BITS)
    keys = kr.keys_for("acme")
    kr.rotate("acme")
    refs = [weakref.ref(keys), weakref.ref(keys.psse), weakref.ref(kr.keys_for("acme")),
            weakref.ref(kr.keys_for("acme").psse)]
    del keys
    kr.shred("acme")
    gc.collect()
    assert all(r() is None for r in refs)


# ------------------------------------------------ the keyring across packages


def ref_export(kr) -> tuple[dict, set]:
    """A reference keyring in `convert`'s crossing form."""
    with kr._lock:
        domains = dict(kr._domains)
    return ({t: [(e.version, e.keys.to_json(), e.created_at, e.grace_until) for e in d.epochs]
             for t, d in domains.items() if d.shredded_at is None},
            {t for t, d in domains.items() if d.shredded_at is not None})


def ref_import(epochs: dict, shredded: set, clock):
    ten = mod("dds_tpu", "models.tenancy")
    HEKeys = mod("dds_tpu", "models.keys").HEKeys
    kr = ten.TenantKeyring(BITS, BITS, clock=clock)
    for t, eps in epochs.items():
        kr._domains[t] = ten._TenantDomain(
            epochs=[ten.KeyEpoch(v, HEKeys.from_json(b), c, g) for v, b, c, g in eps],
            rotations=eps[0][0] - 1)
    for t in shredded:
        kr._domains[t] = ten._TenantDomain(shredded_at=clock())
    return kr


def test_keyring_round_trip_across_packages(pool):
    """A reference keyring (one tenant rotated, one plain, one shredded)
    crosses to the port and back unchanged: the same epochs, moduli,
    HMAC secrets and stats; each side decrypts the other's ciphertexts."""
    ms = seeded_ms(3, 1515)
    clk = FakeClock()
    ref = keyring("dds_tpu", pool, clk)
    ref.keys_for("gold")
    ref.rotate("gold")
    ref.keys_for("lead")
    ref.keys_for("gone")
    ref.shred("gone")
    exported = ref_export(ref)
    port = convert.keyring_from_reference(*exported, paillier_bits=BITS, rsa_bits=BITS,
                                          clock=clk)
    back = convert.keyring_to_reference(port)
    assert back == exported
    assert ref_export(ref_import(*back, clock=clk)) == exported
    assert port.stats() == ref.stats()
    for t in ("gold", "lead"):
        assert port.keys_for(t).psse.n == ref.keys_for(t).psse.n
        assert port.hmac_secret(t) == ref.hmac_secret(t)
    ct, v = ref.encrypt("gold", ms[0])
    assert port.decrypt("gold", ct, v) == ms[0]
    ct, v = port.encrypt("lead", ms[1])
    assert ref.decrypt("lead", ct, v) == ms[1]
    old = ref.keys_for("gold")  # the grace epoch decrypts in the port too
    ct_old = ref._domains["gold"].epochs[1].keys.psse.public.encrypt(ms[2])
    assert port.decrypt("gold", ct_old, 1) == ms[2] and old is ref.keys_for("gold")
    assert port.is_shredded("gone")
    with pytest.raises(mod("dds_tpu_torch", "models.tenancy").TenantShredded):
        port.keys_for("gone")


@pytest.mark.parametrize("bad", ["no_epochs", "old_first", "grace_on_active",
                                 "no_grace_on_old", "bad_json", "live_and_shredded",
                                 "zero_version"])
def test_keyring_from_reference_refuses_bad_epochs(pool, bad):
    blob = pool[0]
    cases = {
        "no_epochs": ({"a": []}, set()),
        "old_first": ({"a": [(1, blob, 0.0, None), (2, pool[1], 1.0, 5.0)]}, set()),
        "grace_on_active": ({"a": [(1, blob, 0.0, 9.0)]}, set()),
        "no_grace_on_old": ({"a": [(2, blob, 0.0, None), (1, pool[1], 1.0, None)]}, set()),
        "bad_json": ({"a": [(1, json.dumps({"OPE": {}}), 0.0, None)]}, set()),
        "live_and_shredded": ({"a": [(1, blob, 0.0, None)]}, {"a"}),
        "zero_version": ({"a": [(0, blob, 0.0, None)]}, set()),
    }
    with pytest.raises(ValueError):
        convert.keyring_from_reference(*cases[bad])
