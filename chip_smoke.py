#!/usr/bin/env python3
"""Chip smoke test of the dds_tpu_torch port on one NVIDIA GPU (H100).

Drives the port's main path — encrypted SumAll over Paillier-2048
ciphertexts through 4 BFT-ABD replicas (quorum 3, f = 1) — and holds every
CUDA kernel on that path against its plain PyTorch version. Phases, each
printing one JSON line; any failure exits non-zero:

1. device     the card, from torch and nvidia-smi (a CUDA device is required);
2. build      nvcc for sm_90a of every kernel source, all started together,
              with the ptxas register / spill / shared-memory report;
3. parity     the Montgomery-multiply kernel against its plain version on
              the card at L = 256, B = 4096 (bit-exact), on column slices,
              at an odd limb count, and a K = 65,536 fold against the
              Python-int product mod n^2;
4. timing     CUDA-event times of warmed folds at K = 65,536 and 8,192 and
              of one B = 4,096 launch, each beside the plain version's time
              and the least time the card could take (the bound);
5. crossover  host Python-int fold vs resident device fold by width: the
              backend's `min_device_batch`;
6. e2e        boot the port's stack on `cuda` (min_device_batch = 0), load
              K = 8,192 rows by PutSet, check SumAll decrypts to the total
              and equals the Python-int fold, time sequential and
              concurrency-8 SumAll; launch counters are zeroed just before
              and read just after, and every kernel of the path must have
              launched;
7. kernels    one {"kernels": [...]} line; then the card's name and power
              limit; then the result line.

    python3 chip_smoke.py              # on the card (needs one GPU)
    python3 chip_smoke.py --rehearse   # the same phases, tiny, on the CPU;
                                       # exits 3 and prints no result

Bound: one 4096-bit Montgomery product in W = 128 32-bit words is
2W^2 + W word products of 2 integer multiply-adds each; Hopper issues 64
such IMADs per SM per clock (half its FP32 FMA rate, which gives the
67 TFLOP/s float32 peak of NVIDIA's data sheet). The byte side counts each
input row read once and the output written once, at 3.35 TB/s.
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
    started = [mont_cuda.start_build()]  # one nvcc per source, all at once
    logs = [mont_cuda.finish_build(*s) for s in started]
    report = [ln.strip() for log in logs for ln in log.splitlines()
              if "registers" in ln or "spill" in ln or "smem" in ln.lower()]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         sources=[str(mont_cuda.SOURCE.relative_to(mont_cuda.CSRC.parent.parent))],
         ptxas=report)
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
                     rounds=1)
        card = {"name": "cpu (rehearsal)", "sms": 132, "clock_mhz": 1980.0}
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        dev = torch.device("cuda")
        sizes = dict(key_bits=2048, B=4096, K_big=65536, K_path=8192, reps_big=5,
                     reps_path=20, reps_plain=2,
                     crossover=[8, 16, 32, 64, 128, 256, 512, 1024],
                     requests=6, rounds=3)
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
    tim = phase_timing(ctx, dev, sizes, card)
    phase_crossover(dev, ctx.n, sizes)
    e2e = asyncio.run(phase_e2e(dev, sizes))

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
