#!/usr/bin/env python3
"""Chip smoke test of the dds_tpu_torch port on one NVIDIA GPU (H100).

Drives the port's two paths — encrypted SumAll over Paillier-2048
ciphertexts through 4 BFT-ABD replicas (quorum 3, f = 1), and the client's
bulk encryption (full-width obfuscators r^n mod n^2 from the modexp kernel)
feeding PutSets into that stack — and holds every CUDA kernel on them
against its plain PyTorch version. Phases, each printing one JSON line;
any failure exits non-zero:

1. device     the card, from torch and nvidia-smi (a CUDA device is required);
2. build      nvcc for sm_90a of every kernel source, all started together,
              with the ptxas register / spill / shared-memory report;
3. parity     the Montgomery-multiply kernel against its plain version on
              the card at L = 256, B = 4096 (bit-exact), on column slices,
              at an odd limb count, and a K = 65,536 fold against the
              Python-int product mod n^2;
4. parity     (what = "exp") the modexp kernel against its plain ladder at
              L = 256, B = 256 with a 64-bit exponent (bit-exact, Montgomery
              domain); a full-width pow_mod (exponent n, B = 8,192) against
              Python `pow` on 16 sampled rows; pow_mod at odd L = 33;
5. timing     CUDA-event times of warmed folds at K = 65,536 and 8,192 and
              of one B = 4,096 launch, each beside the plain version's time
              and the least time the card could take (the bound);
6. timing     (what = "exp") the B = 8,192, E = 512 pow_mod and its exp
              launch alone, beside the bound, the plain ladder on the same
              inputs (timed once, and bit-exact against the launch), and
              host Python `pow`;
7. crossover  host Python-int fold vs resident device fold by width: the
              backend's `min_device_batch`;
8. e2e        boot the port's stack on `cuda` (min_device_batch = 0), load
              K = 8,192 rows by PutSet, check SumAll decrypts to the total
              and equals the Python-int fold, time sequential and
              concurrency-8 SumAll; launch counters are zeroed just before
              and read just after, and every kernel of the path must have
              launched;
9. client     `run.load_provider` with `bulk-encrypt-backend = "cuda"`, then
              4 `DDSHttpClient`s each PutSet 2,048 rows (K = 8,192 in all)
              into a fresh stack: one bulk pre-pass per client, every PSSE
              ciphertext with its own fresh obfuscator; SumAll must decrypt
              to the column's total and equal the Python-int fold of the
              stored ciphertexts; the exp kernel's counter is zeroed just
              before and read just after and must be > 0;
10. kernels   one {"kernels": [...]} line; then the card's name and power
              limit; then the result line.

    python3 chip_smoke.py              # on the card (needs one GPU)
    python3 chip_smoke.py --rehearse   # the same phases, tiny, on the CPU;
                                       # exits 3 and prints no result

Bound: one 4096-bit Montgomery product in W = 128 32-bit words is
2W^2 + W word products of 2 integer multiply-adds each; Hopper issues 64
such IMADs per SM per clock (half its FP32 FMA rate, which gives the
67 TFLOP/s float32 peak of NVIDIA's data sheet). The byte side counts each
input row read once and the output written once, at 3.35 TB/s. A modexp
row is 5E + 14 products in the exp kernel (the window table, then 4
squarings and 1 multiply per digit) and 5E + 16 in pow_mod.

On a card without the `cryptography` package the AES-backed columns (CHE,
None) run as the "Plain" null cipher in the client phase, the reference's
rule for AES-less hosts; the phase prints the schema it ran.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_PER_CLK = 64
PSSE_POS = 2


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]


def residues(ctx, count: int, seed: int) -> np.ndarray:
    """(count, L) uint32 limbs of seeded residues below n."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(count, ctx.L), dtype=np.uint32)
    x[:, -1] = rng.integers(0, int(ctx.N[-1]), size=count, dtype=np.uint32)
    return x


def host_product(ints: list[int], mod: int) -> int:
    acc = 1
    for c in ints:
        acc = acc * c % mod
    return acc


def fold_work(ctx, K: int) -> tuple[float, float]:
    """(integer multiply-adds, bytes) one K-row fold needs: P2 products
    (P2 - 1 tree products + the R^K fix), each 2W^2 + W word products of
    2 IMADs; the K input rows read once and the (1, L) result written."""
    P2 = 1 << max(1, (K - 1).bit_length())
    imads = P2 * (2 * ctx.W * ctx.W + ctx.W) * 2
    return imads, (K + 1) * ctx.L * 4


def exp_work(ctx, B: int, products_per_row: int) -> tuple[float, float]:
    """(integer multiply-adds, bytes) of B modexp rows of
    `products_per_row` Montgomery products each; the (L, B) bases read
    once and the (L, B) result written once."""
    return B * products_per_row * (2 * ctx.W * ctx.W + ctx.W) * 2, 2 * B * ctx.L * 4


def source_path(kernel) -> str:
    from dds_tpu_torch.ops import mont_cuda

    return str(kernel.source.relative_to(mont_cuda.CSRC.parent.parent))


def bound_ms(imads: float, nbytes: float, sms: int, clock_mhz: float) -> tuple[float, str]:
    t_ops = imads / (sms * IMAD_PER_SM_PER_CLK * clock_mhz * 1e6) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int, warm: int, device) -> tuple[float, object]:
    """Mean ms per call: CUDA events around `reps` warmed calls on the card,
    the host clock on the CPU."""
    import torch

    out = None
    for _ in range(warm):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            out = fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps, out
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t) * 1e3 / reps, out


def phase_build(rehearse: bool) -> dict:
    from dds_tpu_torch.ops import mont_cuda

    if rehearse:
        emit("build", skipped="rehearsal: no nvcc on the CPU")
        return {}
    t = time.perf_counter()
    started = [k.start_build() for k in mont_cuda.KERNELS]  # one nvcc each, at once
    logs = [k.finish_build(*s) for k, s in zip(mont_cuda.KERNELS, started)]
    report = [ln.strip() for log in logs for ln in log.splitlines()
              if "registers" in ln or "spill" in ln or "smem" in ln.lower()]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         sources=[source_path(k) for k in mont_cuda.KERNELS], ptxas=report)
    return {"ptxas": report}


def phase_parity(ctx, dev, sizes) -> dict:
    import torch
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx

    B = sizes["B"]
    a = bn.to_device(residues(ctx, B, 1), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, 2), dev).T.contiguous()
    got = mont_cuda.mul(ctx, a, b)
    want = ctx.mont_mul(a.T, b.T).T
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"mont_mul kernel != plain at L={ctx.L}, B={B}: max |diff| {err}")
    # a fold level passes the two halves of one array as column slices
    x = torch.cat([a, b], dim=1)
    sliced = mont_cuda.mul(ctx, x[:, :B], x[:, B:])
    if not torch.equal(sliced, got):
        raise AssertionError("mont_mul kernel on column slices != contiguous operands")
    odd = ModCtx.make((1 << 519) | 0x1F3 | (12345 << 200))
    oa = bn.to_device(residues(odd, 300, 3), dev).T.contiguous()
    ob = bn.to_device(residues(odd, 300, 4), dev).T.contiguous()
    if not torch.equal(mont_cuda.mul(odd, oa, ob), odd.mont_mul(oa.T, ob.T).T):
        raise AssertionError("mont_mul kernel != plain at odd L=33")
    K = sizes["K_big"]
    rows = residues(ctx, K, 5)
    t = time.perf_counter()
    fold = bn.limbs_to_int(bn.to_host(mont_cuda.reduce_mul(ctx, bn.to_device(rows, dev)))[0])
    fold_s = time.perf_counter() - t
    want_fold = host_product(bn.batch_to_ints(rows), ctx.n)
    if fold != want_fold:
        raise AssertionError(f"K={K} kernel fold != Python-int product mod n^2")
    emit("parity", L=ctx.L, B=B, max_abs_err=err, tolerance=0, slices=True,
         odd_L=odd.L, fold_K=K, fold_equals_python_int=True,
         fold_first_call_s=round(fold_s, 3))
    return {"max_abs_err": err}


def phase_timing(ctx, dev, sizes, card) -> dict:
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda

    out = {}
    for K, reps in ((sizes["K_big"], sizes["reps_big"]), (sizes["K_path"], sizes["reps_path"])):
        rows = bn.to_device(residues(ctx, K, 6 + K), dev)
        ms, kout = time_ms(lambda: mont_cuda.reduce_mul(ctx, rows), reps, 2, dev)
        imads, nbytes = fold_work(ctx, K)
        bms, by = bound_ms(imads, nbytes, card["sms"], card["clock_mhz"])
        rec = {"K": K, "launches": mont_cuda.fold_launches(K), "ms": ms,
               "bound_ms": bms, "bound_by": by, "imads": imads, "bytes": nbytes,
               "reps": reps}
        if K == sizes["K_path"]:
            pms, pout = time_ms(lambda: ctx.reduce_mul(rows), sizes["reps_plain"], 1, dev)
            if not bn.to_host(pout).tolist() == bn.to_host(kout).tolist():
                raise AssertionError(f"K={K} kernel fold != plain fold")
            rec["plain_ms"] = pms
            out["path"] = rec
        emit("timing", what="fold", **rec)
    B = sizes["B"]
    a = bn.to_device(residues(ctx, B, 7), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, 8), dev).T.contiguous()
    ms, _ = time_ms(lambda: mont_cuda.mul(ctx, a, b), sizes["reps_path"], 2, dev)
    pms, _ = time_ms(lambda: ctx.mont_mul(a.T, b.T), sizes["reps_plain"], 1, dev)
    imads = B * (2 * ctx.W * ctx.W + ctx.W) * 2
    bms, by = bound_ms(imads, 3 * B * ctx.L * 4, card["sms"], card["clock_mhz"])
    emit("timing", what="mul", L=ctx.L, B=B, ms=ms, plain_ms=pms, bound_ms=bms,
         bound_by=by, imads=imads)
    return out


def phase_parity_exp(ctx, dev, sizes) -> dict:
    """The exp kernel against its plain ladder (Montgomery domain,
    bit-exact), full-width pow_mod against Python `pow`, and odd L."""
    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits

    Bs = sizes["B_exp_small"]
    base = ctx.to_mont(bn.to_device(residues(ctx, Bs, 30), dev)).T.contiguous()
    digits = torch.from_numpy(_exp_to_digits((1 << 63) | 0x5DEECE66D).astype(np.int32)).to(dev)
    got = mont_cuda.exp(ctx, base, digits)
    plain_ms, want = time_ms(lambda: ctx.mont_exp(base.T, digits).T, 1, 0, dev)
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"exp kernel != plain ladder at L={ctx.L}, B={Bs}: max |diff| {err}")
    small_ms, _ = time_ms(lambda: mont_cuda.exp(ctx, base, digits), 5, 1, dev)

    key = bench_paillier_key(sizes["key_bits"])
    B = sizes["B_exp"]
    rows = residues(ctx, B, 31)
    t = time.perf_counter()
    out = bn.to_host(mont_cuda.pow_mod(ctx, bn.to_device(rows, dev), key.n))
    first_s = time.perf_counter() - t
    ints = bn.batch_to_ints(rows)
    sample = np.random.default_rng(32).choice(B, size=min(16, B), replace=False)
    for i in sample:
        if bn.limbs_to_int(out[i]) != pow(ints[i], key.n, key.nsquare):
            raise AssertionError(f"pow_mod row {i} != Python pow (B={B}, exponent n)")

    odd = ModCtx.make((1 << 519) | 0x1F3 | (12345 << 200))
    ob = bn.batch_to_ints(residues(odd, 64, 33))
    for e in (0, 1, 2, 65537):
        got_odd = mont_cuda.pow_mod(odd, bn.to_device(bn.ints_to_batch(ob, odd.L), dev), e)
        if bn.batch_to_ints(bn.to_host(got_odd)) != [pow(b, e, odd.n) for b in ob]:
            raise AssertionError(f"pow_mod at odd L={odd.L} != Python pow (exp {e})")
    E = len(digits)
    rec = {"L": ctx.L, "B_small": Bs, "E_small": E, "max_abs_err": err, "tolerance": 0,
           "plain_ms": plain_ms, "plain_products_per_row": 5 * E + 14,
           "plain_ms_per_product": plain_ms / (5 * E + 14), "kernel_ms_small": small_ms,
           "B": B, "exponent_bits": key.n.bit_length(), "rows_checked": len(sample),
           "pow_equals_python": True, "odd_L": odd.L, "first_call_s": first_s}
    emit("parity", what="exp", **rec)
    return rec


def phase_timing_exp(ctx, dev, sizes, card) -> dict:
    """Warmed pow_mod and exp launches at the client path's shape: B rows,
    exponent n (E digits), beside the bound and host Python `pow`."""
    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import _exp_to_digits

    key = bench_paillier_key(sizes["key_bits"])
    B, reps = sizes["B_exp"], sizes["reps_exp"]
    bases = bn.to_device(residues(ctx, B, 34), dev)
    digits = torch.from_numpy(_exp_to_digits(key.n).astype(np.int32)).to(dev)
    E = len(digits)
    pow_ms, _ = time_ms(lambda: mont_cuda.pow_mod(ctx, bases, key.n), reps, 1, dev)
    base_mont = bases.T.contiguous()  # residues below n: a valid domain input
    exp_ms, got = time_ms(lambda: mont_cuda.exp(ctx, base_mont, digits), reps, 0, dev)
    Bc = sizes["ops_per_client"]  # one client pre-pass's width
    exp_client_ms, _ = time_ms(
        lambda: mont_cuda.exp(ctx, base_mont[:, :Bc].contiguous(), digits), 1, 0, dev)
    plain_ms, want = time_ms(lambda: ctx.mont_exp(bases, digits).T, 1, 0, dev)
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"exp kernel != plain ladder at B={B}, E={len(digits)}: "
                             f"max |diff| {err}")
    imads, nbytes = exp_work(ctx, B, 5 * E + 14)
    bms, by = bound_ms(imads, nbytes, card["sms"], card["clock_mhz"])
    pimads, pbytes = exp_work(ctx, B, 5 * E + 16)
    pbms, pby = bound_ms(pimads, pbytes, card["sms"], card["clock_mhz"])
    rng = np.random.default_rng(35)
    host = []
    for _ in range(16):
        r = int.from_bytes(rng.bytes(key.n.bit_length() // 8), "little") % key.n
        t = time.perf_counter()
        pow(r, key.n, key.nsquare)
        host.append((time.perf_counter() - t) * 1e3)
    rec = {"L": ctx.L, "B": B, "E": E, "reps": reps,
           "pow_ms": pow_ms, "pow_products_per_row": 5 * E + 16,
           "obfuscators_per_s": B / (pow_ms / 1e3),
           "pow_bound_ms": pbms, "pow_bound_by": pby,
           "exp_ms": exp_ms, "exp_products_per_row": 5 * E + 14,
           "max_abs_err": err, "plain_ms": plain_ms,
           "B_client": Bc, "exp_ms_client_width": exp_client_ms,
           "exp_bound_ms": bms, "exp_bound_by": by, "exp_imads": imads, "exp_bytes": nbytes,
           "host_pow_ms_median": statistics.median(host),
           "host_obfuscators_per_s": 1e3 / statistics.median(host)}
    emit("timing", what="exp", **rec)
    return rec


def phase_crossover(dev, n2, sizes) -> int:
    """Smallest width from which the resident device fold beats the host
    fold at every larger measured width."""
    from dds_tpu_torch.models.backend import CudaBackend, _host_fold

    be = CudaBackend(device=dev, min_device_batch=0)
    rng = np.random.default_rng(9)
    table = []
    for K in sizes["crossover"]:
        cs = [int.from_bytes(rng.bytes(512), "little") % n2 for _ in range(K)]
        be.modmul_fold_resident(cs, n2)  # ingest + build the row memo
        host, dvc = [], []
        for _ in range(5):
            t = time.perf_counter()
            h = _host_fold(cs, n2)
            host.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            d = be.modmul_fold_resident(cs, n2)
            dvc.append((time.perf_counter() - t) * 1e3)
            if h != d:
                raise AssertionError(f"crossover K={K}: device fold != host fold")
        table.append({"K": K, "host_ms": statistics.median(host),
                      "device_ms": statistics.median(dvc)})
    cross = None
    for row in reversed(table):
        if row["device_ms"] >= row["host_ms"]:
            break
        cross = row["K"]
    emit("crossover", table=table, min_device_batch=cross)
    return cross


async def phase_e2e(dev, sizes) -> dict:
    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K = sizes["K_path"]
    rng = np.random.default_rng(11)
    t = time.perf_counter()
    blinds = [pk.blind(int.from_bytes(rng.bytes(pk.n.bit_length() // 8 - 1), "little"))
              for _ in range(min(64, K))]
    rows = [[i, f"name-{i}", pk.encrypt(i + 1, rn=blinds[i % len(blinds)]),
             2, "a", "b", "c", "blob"] for i in range(K)]
    total = K * (K + 1) // 2
    gen_s = time.perf_counter() - t

    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    mont_cuda.launches.reset()  # the main path's run starts here
    tracer.reset()
    dep = await launch(cfg)
    try:
        port = dep.server.cfg.port
        sem = asyncio.Semaphore(64)

        async def put(r):
            async with sem:
                return await http_request("127.0.0.1", port, "POST", "/PutSet",
                                          json.dumps({"contents": r}).encode())

        t = time.perf_counter()
        statuses = await asyncio.gather(*(put(r) for r in rows))
        put_s = time.perf_counter() - t
        if not all(s == 200 for s, _ in statuses):
            raise AssertionError("PutSet failures during load")
        target = f"/SumAll?position={PSSE_POS}&nsqr={pk.nsquare}"

        async def sumall() -> int:
            status, body = await http_request("127.0.0.1", port, "GET", target,
                                              timeout=300.0)
            if status != 200:
                raise AssertionError(f"SumAll failed: {status} {body[:200]!r}")
            return int(json.loads(body)["result"])

        t = time.perf_counter()
        result = await sumall()
        cold_s = time.perf_counter() - t
        if key.decrypt(result) != total:
            raise AssertionError("SumAll does not decrypt to the plaintext total")
        if result != host_product([r[PSSE_POS] for r in rows], pk.nsquare):
            raise AssertionError("SumAll != Python-int fold of the ciphertexts")

        tracer.reset()
        seq = []
        for _ in range(sizes["requests"]):
            t = time.perf_counter()
            if await sumall() != result:
                raise AssertionError("sequential SumAll changed")
            seq.append(time.perf_counter() - t)
        phases = {name: s["mean_ms"] for name, s in tracer.summary().items()
                  if name in ("abd.read_tags", "abd.fetch", "proxy.fold",
                              "proxy.fetch_stored", "http.GET.SumAll",
                              "kernel.fold", "kernel.store.reduce.dispatch",
                              "kernel.store.reduce.execute")}
        t = time.perf_counter()
        for _ in range(sizes["rounds"]):
            got = await asyncio.gather(*(sumall() for _ in range(8)))
            if any(g != result for g in got):
                raise AssertionError("concurrent SumAll changed")
        per_req = (time.perf_counter() - t) / (sizes["rounds"] * 8)
    finally:
        await dep.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = mont_cuda.launches.value  # read just after the main path
    sumalls = 1 + sizes["requests"] + 8 * sizes["rounds"]
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("the main path never launched the mont_mul kernel")
    best = min(min(seq), per_req)
    rec = {
        "K": K, "key_bits": sizes["key_bits"], "replicas": 4, "quorum": 3,
        "adds_per_sec": (K - 1) / best,
        "sumall_ms_seq": min(seq) * 1e3,
        "sumall_ms_seq_median": statistics.median(seq) * 1e3,
        "sumall_ms_concurrent": per_req * 1e3,
        "sumall_ms_cold": cold_s * 1e3,
        "putset_ops_per_sec": K / put_s,
        "rows_gen_s": gen_s,
        "phase_mean_ms": phases,
        "sumalls": sumalls,
        "launches": launches,
        "launches_per_sumall": launches / sumalls,
        "decrypt_ok": True,
    }
    emit("e2e", **rec)
    return rec


def make_digest(n_ops: int, seed: int):
    """`benchmarks/put_concurrency.py::make_digest`'s PutSet rows, row for
    row: 8 columns of the canonical schema, the PSSE column (position 2)
    below 2^24."""
    import random

    from dds_tpu_torch.clt import instructions as I

    rng = random.Random(seed)
    rows = [
        [rng.randrange(1 << 16), f"name-{i}", rng.randrange(1 << 24),
         rng.randrange(1, 1 << 16), "a", "b", "c", f"blob-{i}-{seed}"]
        for i in range(n_ops)
    ]
    return I.Digest([I.PutSet(r) for r in rows])


async def phase_client(dev, sizes) -> dict:
    """`put_concurrency --bulk`'s shape through the port: one provider with
    the cuda bulk backend shared by C clients, each executing its own
    PutSet digest (bulk pre-pass, then the PutSets) against 4 replicas."""
    import random

    import torch
    from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models._symmetric import aes_available
    from dds_tpu_torch.models.facade import DEFAULT_SCHEMA
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch, load_provider
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    C, ops = sizes["clients"], sizes["ops_per_client"]
    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    cfg.client.paillier_bits = sizes["key_bits"]
    cfg.client.rsa_bits = sizes["rsa_bits"]
    cfg.client.bulk_encrypt_backend = "cuda"
    cfg.client.device = dev.type
    t = time.perf_counter()
    provider = load_provider(cfg)
    keygen_s = time.perf_counter() - t
    schema = list(DEFAULT_SCHEMA)
    if not aes_available():  # the reference's rule for AES-less hosts
        schema = ["Plain" if c in ("CHE", "None") else c for c in schema]
    digests = [make_digest(ops, seed=i) for i in range(C)]
    t = time.perf_counter()
    for instr in digests[0].payload[:32]:  # empty pool: the per-op DJN path
        provider.encrypt_row(instr.set, 8, schema)
    enc_row_ms = (time.perf_counter() - t) / 32 * 1e3

    dep = await launch(cfg)
    try:
        port = dep.server.cfg.port
        clients = [
            DDSHttpClient(provider, ClientConfig(proxies=[f"127.0.0.1:{port}"],
                                                 schema=schema),
                          rng=random.Random(1000 + i))
            for i in range(C)
        ]
        mont_cuda.exp_launches.reset()  # the client path's run starts here
        mont_cuda.launches.reset()
        tracer.reset(max_events=1 << 21)  # keep the pre-pass spans of the whole run
        t, t_wall = time.perf_counter(), time.time()
        reports = await asyncio.gather(*(c.execute(d) for c, d in zip(clients, digests)))
        wall = time.perf_counter() - t
        spans = {name: {k: v[k] for k in ("count", "mean_ms", "p95_ms")}
                 for name, v in tracer.summary().items()
                 if name.startswith("kernel.pow") or name in ("http.POST.PutSet", "abd.write")}
        # each pre-pass as [start, enqueued, done] seconds from the clients'
        # start, to show how the pre-passes queue on the one stream. A
        # pre-pass records its dispatch span and then its execute span, both
        # after its wait: pair each dispatch with the next execute.
        executes = sorted(tracer.events("kernel.pow.execute"), key=lambda e: e.ts)
        windows = []
        for d in sorted(tracer.events("kernel.pow.dispatch"), key=lambda e: e.ts):
            e = next(x for x in executes if x.ts >= d.ts)
            executes.remove(e)
            done = e.ts - t_wall
            windows.append([round(done - (e.dur_ms + d.dur_ms) / 1e3, 3),
                            round(done - e.dur_ms / 1e3, 3), round(done, 3)])
        if sum(r.succeeded for r in reports) != C * ops:
            raise AssertionError(f"PutSets failed: {[vars(r) for r in reports]}")
        if provider._blind_pool:
            raise AssertionError(f"{len(provider._blind_pool)} obfuscators left unused")

        nsqr = provider.keys.psse.public.nsquare
        status, body = await http_request("127.0.0.1", port, "GET",
                                          f"/SumAll?position={PSSE_POS}&nsqr={nsqr}",
                                          timeout=300.0)
        if status != 200:
            raise AssertionError(f"SumAll failed: {status} {body[:200]!r}")
        result = int(json.loads(body)["result"])
        total = sum(instr.set[PSSE_POS] for d in digests for instr in d.payload)
        if provider.keys.psse.decrypt(result) != total:
            raise AssertionError("client-phase SumAll does not decrypt to the total")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        exp_count, mul_count = mont_cuda.exp_launches.value, mont_cuda.launches.value

        sem = asyncio.Semaphore(64)

        async def get(key):
            async with sem:
                st, b = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key}")
            if st != 200:
                raise AssertionError(f"GetSet {key} failed: {st}")
            return int(json.loads(b)["contents"][PSSE_POS])

        keys = [k for c in clients for k in c.stored_keys]
        stored = await asyncio.gather(*(get(k) for k in keys))
    finally:
        await dep.stop()
    if len(set(stored)) != C * ops:
        raise AssertionError("two PSSE ciphertexts are equal: an obfuscator was reused")
    if result != host_product(stored, nsqr):
        raise AssertionError("client-phase SumAll != Python-int fold of the stored ciphertexts")
    if dev.type == "cuda" and exp_count <= 0:
        raise AssertionError("the client path never launched the mont_exp kernel")
    rec = {
        "schema": schema, "clients": C, "ops_per_client": ops, "K": C * ops,
        "key_bits": sizes["key_bits"], "replicas": 4, "quorum": 3,
        "keygen_s": keygen_s, "enc_row_ms_djn": enc_row_ms,
        "putset_ops_per_sec": C * ops / wall, "wall_s": wall,
        "prepass_ms": spans.get("kernel.pow.execute", {}),
        "prepass_dispatch_ms": spans.get("kernel.pow.dispatch", {}),
        "prepass_windows_s": windows,
        "spans": spans, "exp_launches": exp_count, "mul_launches": mul_count,
        "sumall_decrypts": True, "sumall_equals_python_int": True,
        "distinct_psse_ciphertexts": len(set(stored)),
    }
    emit("client", **rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase tiny on the CPU (exits 3, no result)")
    args = ap.parse_args(argv)

    import torch

    if args.rehearse:
        dev = torch.device("cpu")
        sizes = dict(key_bits=512, B=64, K_big=512, K_path=256, reps_big=1,
                     reps_path=2, reps_plain=1, crossover=[8, 32], requests=2,
                     rounds=1, B_exp_small=8, B_exp=16, reps_exp=1, rsa_bits=512,
                     clients=2, ops_per_client=64)
        card = {"name": "cpu (rehearsal)", "sms": 132, "clock_mhz": 1980.0}
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        dev = torch.device("cuda")
        sizes = dict(key_bits=2048, B=4096, K_big=65536, K_path=8192, reps_big=5,
                     reps_path=20, reps_plain=2,
                     crossover=[8, 16, 32, 64, 128, 256, 512, 1024],
                     requests=6, rounds=3, B_exp_small=256, B_exp=8192, reps_exp=2,
                     rsa_bits=1024, clients=4, ops_per_client=2048)
        props = torch.cuda.get_device_properties(0)
        card = {
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": props.multi_processor_count,
            "clock_mhz": float(nvidia_smi("clocks.max.sm").split()[0]),
            "smi": nvidia_smi("name,power.limit"),
            "clocks_now": nvidia_smi("clocks.sm,power.draw,temperature.gpu"),
        }
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda)

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx

    ctx = ModCtx.make(bench_paillier_key(sizes["key_bits"]).nsquare)
    phase_build(args.rehearse)
    par = phase_parity(ctx, dev, sizes)
    par_exp = phase_parity_exp(ctx, dev, sizes)
    tim = phase_timing(ctx, dev, sizes, card)
    tim_exp = phase_timing_exp(ctx, dev, sizes, card)
    phase_crossover(dev, ctx.n, sizes)
    e2e = asyncio.run(phase_e2e(dev, sizes))
    client = asyncio.run(phase_client(dev, sizes))

    path = tim["path"]
    kernels = [{
        "name": "mont_mul",
        "route": "cuda",
        "source": "dds_tpu_torch/csrc/mont_mul.cu",
        "replaces": "dds_tpu/ops/mont_mxu.py:119",
        "tpu_twin": "mont_mxu._make_prod_kernel + _redc (v2); pallas_mont._make_mul_kernel (v1)",
        "launches": e2e["launches"],
        "max_abs_err": par["max_abs_err"],
        "per": f"one K={path['K']} fold ({path['launches']} launches)",
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": None,
    }, {
        "name": "mont_exp",
        "route": "cuda",
        "source": "dds_tpu_torch/csrc/mont_exp.cu",
        "replaces": "dds_tpu/ops/pallas_mont.py:152",
        "tpu_twin": "pallas_mont._make_exp_kernel via _exp_call / exp_lm",
        "launches": client["exp_launches"],
        "max_abs_err": max(par_exp["max_abs_err"], tim_exp["max_abs_err"]),
        "per": f"one launch, B={tim_exp['B']}, E={tim_exp['E']} "
               f"({tim_exp['exp_products_per_row']} products per row)",
        "ms": tim_exp["exp_ms"],
        "plain_ms": tim_exp["plain_ms"],
        "bound_ms": tim_exp["exp_bound_ms"],
        "bound_by": tim_exp["exp_bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal finished on the CPU; no result", file=sys.stderr)
        return 3
    print(card["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
