"""Sanctum host plane: per-key CRT decrypt plans and the backend handle.

Copy of `dds_tpu/sanctum/plane.py`. The device leg lives in
`sanctum.device`, imported by `plan_for` only when a caller opts in.

Lifetime contract: every derived secret (the CRT moduli p^2 and q^2, the
exponents p-1 and q-1, the Montgomery constants for them) lives on a plan
object reachable ONLY from the key that owns it. A `weakref.finalize`
closes the plan when the key object is garbage-collected;
`PaillierKey.scrub()` does it eagerly. Nothing here writes into
`ModCtx.make`'s shared cache or any other module-level store.

The host plan computes its legs with Python's `pow`: the reference's
C++ host bignum (`native/`) is not ported, and the reference's own branch
without that toolchain is Python's `pow` too, with the same values bit
for bit.
"""

from __future__ import annotations

import threading
import weakref

import torch

_PLANS_ATTR = "_sanctum_plans"
_PLANS_LOCK = threading.Lock()


class SecretBackend:
    """Policy handle for where secret-material computation runs.

    `device=False` (the default posture) keeps both CRT legs on the host;
    `device=True` is the explicit opt-in that stacks them into one batch
    on the card (`"cuda"`). A device name (`"cuda"`, `"cpu"`, a
    `torch.device`) picks the device plan's device: `"cpu"` runs the
    kernels' plain PyTorch versions, for hosts without a card. A `cuda`
    request without a card raises here. This is NOT a
    `models.backend.CryptoBackend`: it has no `powmod_batch` on purpose,
    so secret moduli can never be passed through the public-parameter
    interface."""

    name = "sanctum"
    # the marker PaillierKey.decrypt_batch checks: public CryptoBackends
    # do not carry it, so passing one raises
    secret_plane = True

    def __init__(self, device: bool | str | torch.device = False, chunk: int = 4096):
        if device is False or device is None:
            self.device = None
        else:
            self.device = torch.device("cuda" if device is True else device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "SecretBackend: no CUDA device available (pass device='cpu' "
                    "to run the device plan's plain path on the host)"
                )
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)


def is_secret_backend(obj) -> bool:
    """True for objects allowed to carry secret-material computation (the
    `secret_plane` marker, see SecretBackend)."""
    return getattr(obj, "secret_plane", False) is True


def _crt_recombine(xps, xqs, p, q, n, hp, hq, qinv):
    """The L-function and CRT recombination shared by the host and device
    plans: m_p = L_p(x_p) h_p, m_q = L_q(x_q) h_q, then Garner. One body,
    so the two plans cannot drift."""
    out = []
    for xp, xq in zip(xps, xqs):
        mp = (xp - 1) // p % p * hp % p
        mq = (xq - 1) // q % q * hq % q
        u = (mp - mq) * qinv % p
        out.append((mq + u * q) % n)
    return out


class HostCrtPlan:
    """Per-key batched CRT decrypt on the host: p^2, q^2 and the CRT
    constants computed once per key, each leg by Python's `pow`."""

    def __init__(self, key):
        p, q, n = key.p, key.q, key.n
        hp, hq, qinv = key._crt
        self.p, self.q, self.n = p, q, n
        self.p2, self.q2 = p * p, q * q
        self.hp, self.hq, self.qinv = hp, hq, qinv
        self.closed = False

    def decrypt_batch(self, cs: list[int]) -> list[int]:
        if self.closed:
            raise RuntimeError("sanctum plan is closed (key scrubbed)")
        p, q, p2, q2 = self.p, self.q, self.p2, self.q2
        xps = [pow(c % p2, p - 1, p2) for c in cs]
        xqs = [pow(c % q2, q - 1, q2) for c in cs]
        return _crt_recombine(xps, xqs, p, q, self.n, self.hp, self.hq, self.qinv)

    def close(self) -> None:
        """Drop the derived secrets. Python ints are immutable, so there is
        nothing to overwrite in place: 'zeroization' unlinks every
        reference this plan holds; the device plan also zero-fills its
        numpy copies."""
        self.p = self.q = self.n = self.p2 = self.q2 = 0
        self.hp = self.hq = self.qinv = 0
        self.closed = True


def plan_for(key, backend: SecretBackend | None = None):
    """The per-key Sanctum plan for `backend`'s posture (None or a host
    handle -> HostCrtPlan; a device handle -> the device plan on its
    device). Created once per (key, posture) and stored in the key's own
    `__dict__`, so the plan lives exactly as long as the key, with a
    `weakref.finalize` that closes it when the key is collected without
    an explicit `scrub()`."""
    device = getattr(backend, "device", None) if backend is not None else None
    plans = key.__dict__.get(_PLANS_ATTR)
    if plans is None:
        with _PLANS_LOCK:
            plans = key.__dict__.get(_PLANS_ATTR)
            if plans is None:
                plans = {}
                # frozen dataclass: write the instance dict directly, as
                # functools.cached_property does
                key.__dict__[_PLANS_ATTR] = plans
    tag = f"device:{device}" if device else "host"
    plan = plans.get(tag)
    if plan is None:
        with _PLANS_LOCK:
            plan = plans.get(tag)
            if plan is None:
                if device:
                    from dds_tpu_torch.sanctum.device import SecretDevicePlan

                    plan = SecretDevicePlan(key, chunk=getattr(backend, "chunk", 4096),
                                            device=device)
                else:
                    plan = HostCrtPlan(key)
                # the plan holds no reference back to `key` (it copies the
                # ints it needs), or the finalizer could never fire
                weakref.finalize(key, plan.close)
                plans[tag] = plan
    return plan


def scrub_key(key) -> None:
    """Close every Sanctum plan a key accumulated and drop its cached CRT
    constants: the body of `PaillierKey.scrub`."""
    with _PLANS_LOCK:
        plans = key.__dict__.pop(_PLANS_ATTR, None)
    for plan in (plans or {}).values():
        plan.close()
    key.__dict__.pop("_crt", None)
