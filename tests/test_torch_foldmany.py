"""Coalesced small SumAlls: `ops/foldmany.fold_many` and the proxy's
coalescing window, against the reference.

`dds_tpu_torch.ops.foldmany.fold_many` on the CPU (the kernel wrappers'
plain path) in each DDS_KARATSUBA mode against `dds_tpu.ops.foldmany.
fold_many` (kernel "v2" with its Pallas product in interpret mode, and
"jnp") and against Python ints; `CudaBackend(device="cpu").
modmul_fold_many`; and the port's REST proxy: the twins of
tests/test_rest.py's coalescing tests, `stop()` with waiters pending, and a
storm of SumAlls racing a PutSet, and the twin of the reference's
coalesced-SumAll linearizability test, a storm racing a WriteElement that
rewrites a stored ciphertext in place. The proxy tests
gate on `threading.Event`s, never on timing: the first host fold of a
burst holds the in-flight signal open until a coalesced dispatch has run.
Exact integer arithmetic: tolerance zero.
"""

import asyncio
import contextlib
import json
import random
import threading

import pytest

from dds_tpu.ops import foldmany as ref_foldmany
from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.http.miniserver import http_request
from dds_tpu_torch.models.backend import CpuBackend, CudaBackend
from dds_tpu_torch.ops import foldmany
from dds_tpu_torch.run import launch
from dds_tpu_torch.utils.config import DDSConfig
from dds_tpu_torch.utils.trace import tracer

N = random.Random(256).getrandbits(256) | (1 << 255) | 1  # L = 16


def _prod(cs, mod):
    acc = 1
    for c in cs:
        acc = acc * c % mod
    return acc


@pytest.mark.parametrize("mode", ["0", "1", "2"])
@pytest.mark.parametrize("sizes", [[1, 5, 9], [6]], ids=["ragged-R3", "single"])
def test_fold_many_matches_reference_fold_many(monkeypatch, mode, sizes):
    """Ragged folds padded to a shared power-of-two width, R = 3 requests
    padded to 4 with dummy folds, and a lone request."""
    monkeypatch.setenv("DDS_KARATSUBA", mode)
    rng = random.Random(len(sizes) * 10 + int(mode))
    folds = [[rng.randrange(N) for _ in range(k)] for k in sizes]
    folds[0][0] = N - 1
    want = [_prod(f, N) for f in folds]
    got = foldmany.fold_many(folds, N, device="cpu")
    assert got == want
    assert ref_foldmany.fold_many(folds, N, kernel="v2") == want
    assert ref_foldmany.fold_many(folds, N, kernel="jnp") == want


def test_fold_many_spans_and_input_checks():
    tracer.reset()
    cs = [[3, 5, N + 7], [N - 2]]  # operands at or above N reduce first
    assert foldmany.fold_many(cs, N, device="cpu") == [105 % N, N - 2]
    spans = tracer.events("kernel.foldmany.execute")
    assert spans and spans[-1].meta["R"] == 2 and spans[-1].meta["P2"] == 4
    with pytest.raises(ValueError):
        foldmany.fold_many([], N, device="cpu")
    with pytest.raises(ValueError):
        foldmany.fold_many([[2], []], N, device="cpu")


def test_backend_modmul_fold_many_on_cpu():
    rng = random.Random(5)
    n2 = bench_paillier_key(512).public.nsquare
    folds = [[rng.randrange(1, n2) for _ in range(k)] for k in (7, 2, 30)]
    be = CudaBackend(device="cpu")
    assert be.modmul_fold_many(folds, n2) == [_prod(f, n2) for f in folds]
    assert not hasattr(CpuBackend(), "modmul_fold_many")  # its proxy never coalesces


# -- the proxy's coalescer -----------------------------------------------------

KEY = bench_paillier_key(512)


@contextlib.asynccontextmanager
async def _proxy(min_device_batch=10, window=0.05):
    cfg = DDSConfig()
    cfg.proxy.device = "cpu"
    cfg.proxy.min_device_batch = min_device_batch
    cfg.proxy.coalesce_window = window
    dep = await launch(cfg)
    try:
        yield dep.server
    finally:
        await dep.stop()


async def _call(server, method, target, obj=None):
    body = json.dumps(obj).encode() if obj is not None else None
    return await http_request("127.0.0.1", server.cfg.port, method, target, body,
                              timeout=30.0)


async def _put_values(server, vals):
    keys = []
    for v in vals:
        st, body = await _call(server, "POST", "/PutSet",
                               {"contents": [str(KEY.public.encrypt(v))]})
        assert st == 200
        keys.append(body.decode())
    return keys


def _gate(be):
    """Spy on the backend's two fold paths. The first host fold blocks
    until a coalesced dispatch has run, so the in-flight signal holds open
    while the rest of a burst piles into the window; the wait runs on a
    worker thread, never on the event loop, so the release is guaranteed."""
    calls = {"many": 0, "single": 0}
    coalesced = threading.Event()
    orig_many, orig_single = be.modmul_fold_many, be.modmul_fold_resident

    def single(cs, mod):
        calls["single"] += 1
        if calls["single"] == 1:
            assert coalesced.wait(30), "coalesced dispatch never ran"
        return orig_single(cs, mod)

    def many(folds, mod):
        calls["many"] += 1
        coalesced.set()
        return orig_many(folds, mod)

    be.modmul_fold_resident, be.modmul_fold_many = single, many
    return calls, orig_many


def test_concurrent_small_sumalls_coalesce_into_one_dispatch():
    """Twin of tests/test_rest.py::test_concurrent_small_sumalls_coalesce_
    into_one_dispatch: K = 6 folds sit below the crossover (10), a group's
    combined width clears it, so the group goes to one device pass."""

    async def go():
        async with _proxy() as server:
            tracer.reset()
            calls, _ = _gate(server.backend)
            vals = [random.Random(1).randrange(1 << 24) for _ in range(6)]
            await _put_values(server, vals)
            target = f"/SumAll?position=0&nsqr={KEY.public.nsquare}"
            results = await asyncio.gather(*(_call(server, "GET", target) for _ in range(5)))
            for st, data in results:
                assert st == 200
                assert KEY.decrypt(int(json.loads(data)["result"])) == sum(vals)
            assert calls["many"] >= 1
            assert calls["many"] + calls["single"] < 5
            waits = tracer.events("proxy.coalesce_wait")
            assert waits and max(e.meta["batch"] for e in waits) >= 2
            assert tracer.events("proxy.coalesced_fold")

            # a lone small aggregate pays no window: straight host path
            before = dict(calls)
            st, data = await _call(server, "GET", target)
            assert st == 200 and KEY.decrypt(int(json.loads(data)["result"])) == sum(vals)
            assert calls == {"many": before["many"], "single": before["single"] + 1}

            # window 0 disables coalescing
            server.cfg.coalesce_window = 0.0
            before = dict(calls)
            results = await asyncio.gather(*(_call(server, "GET", target) for _ in range(3)))
            assert all(st == 200 for st, _ in results)
            assert calls == {"many": before["many"], "single": before["single"] + 3}

    asyncio.run(go())


def test_coalesced_dispatch_failure_fails_all_waiters_cleanly():
    """Twin of tests/test_rest.py::test_coalesced_dispatch_failure_fails_all_
    waiters_cleanly: a failing coalesced dispatch answers 500 to every
    waiter of its group (nobody hangs), and the next burst succeeds."""

    async def go():
        async with _proxy() as server:
            be = server.backend
            calls, orig_many = _gate(be)
            gated_many = be.modmul_fold_many
            boom = {"on": True}

            def maybe_boom(folds, mod):
                if boom["on"]:
                    gated_many(folds, mod)  # releases the gate
                    raise RuntimeError("device fell off")
                return orig_many(folds, mod)

            be.modmul_fold_many = maybe_boom
            vals = [2, 3, 5, 7, 11, 13]
            await _put_values(server, vals)
            target = f"/SumAll?position=0&nsqr={KEY.public.nsquare}"
            results = await asyncio.wait_for(
                asyncio.gather(*(_call(server, "GET", target) for _ in range(5))), 60)
            statuses = sorted(st for st, _ in results)
            assert statuses[0] == 200 and statuses[-1] == 500

            boom["on"] = False
            results = await asyncio.wait_for(
                asyncio.gather(*(_call(server, "GET", target) for _ in range(5))), 60)
            for st, data in results:
                assert st == 200
                assert KEY.decrypt(int(json.loads(data)["result"])) == sum(vals)
            assert calls["many"] >= 1

    asyncio.run(go())


def test_stop_fails_pending_waiters_with_connection_error():
    async def go():
        async with _proxy(window=60.0) as server:
            server._folds_inflight = 1  # a fold in flight: arrivals queue
            waiters = [asyncio.ensure_future(server._fold([2, 3], N)) for _ in range(3)]
            for _ in range(100):
                if sum(map(len, server._fold_pending.values())) == 3:
                    break
                await asyncio.sleep(0)
            assert len(server._fold_pending[N]) == 3
            drainer = server._fold_drainer
            server._folds_inflight = 0
            await server.stop()
            for w in waiters:
                with pytest.raises(ConnectionError):
                    await w
            assert server._fold_pending == {} and server._fold_drainer is None
            assert drainer.cancelled()

    asyncio.run(go())


def test_coalesced_sumalls_racing_a_putset_see_old_or_new_total():
    """While a PutSet adds a record, a storm of concurrent small SumAlls
    that share coalesced dispatches must each decrypt to the total before
    the write or after it, never anything else: coalescing shares the
    math, each request's operands still come from its own quorum read."""

    async def go():
        async with _proxy(min_device_batch=8) as server:
            calls, _ = _gate(server.backend)
            base = [10, 20, 30, 40]
            await _put_values(server, base)
            target = f"/SumAll?position=0&nsqr={KEY.public.nsquare}"

            async def storm(k):
                rs = await asyncio.gather(*(_call(server, "GET", target) for _ in range(k)))
                assert all(st == 200 for st, _ in rs)
                return [KEY.decrypt(int(json.loads(d)["result"])) for _, d in rs]

            sums, _ = await asyncio.gather(storm(12), _put_values(server, [999]))
            assert set(sums) <= {sum(base), sum(base) + 999}, sums
            assert calls["many"] >= 1  # the coalesced path really ran
            assert set(await storm(4)) == {sum(base) + 999}

    asyncio.run(go())


def test_coalesced_sumalls_see_old_or_new_never_mixed_garbage():
    """Twin of tests/test_linearizability.py's test of that name: while a
    WriteElement rewrites a stored ciphertext in place (v_old -> v_new), a
    storm of concurrent small SumAlls that share coalesced dispatches must
    each decrypt to the old total or the new one, never anything else."""

    async def go():
        async with _proxy(min_device_batch=8) as server:
            calls, _ = _gate(server.backend)
            base = [10, 20, 30, 40]
            keys = await _put_values(server, base)
            old, new = sum(base), sum(base) - base[-1] + 999
            target = f"/SumAll?position=0&nsqr={KEY.public.nsquare}"

            async def storm(k):
                rs = await asyncio.gather(*(_call(server, "GET", target) for _ in range(k)))
                assert all(st == 200 for st, _ in rs)
                return [KEY.decrypt(int(json.loads(d)["result"])) for _, d in rs]

            async def rewrite():
                st, _ = await _call(server, "PUT", f"/WriteElement/{keys[-1]}?position=0",
                                    {"value": str(KEY.public.encrypt(999))})
                assert st == 200

            sums, _ = await asyncio.gather(storm(12), rewrite())
            assert set(sums) <= {old, new}, sums
            assert calls["many"] >= 1  # the coalesced path really ran
            assert set(await storm(4)) == {new}

    asyncio.run(go())
