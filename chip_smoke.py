#!/usr/bin/env python3
"""Chip smoke test of the dds_tpu_torch port on one NVIDIA GPU (H100).

Drives the port's paths — encrypted SumAll over Paillier-2048 ciphertexts
through 4 BFT-ABD replicas (quorum 3, f = 1) in each DDS_KARATSUBA product
family, coalesced small SumAlls, the client's bulk encryption (full-width
obfuscators r^n mod n^2 from the modexp kernel) feeding PutSets into that
stack, MultAll over RSA-1024 ciphertexts (L = 64) in each family, the
generated mixed workload over every data route, the resident plane's fused
multi-group folds and write-path ingest, Stratum's tiered folds,
Prism's encrypted analytics (MatVec, WeightedSum, GroupBySum), the
search plane's indexed Search*/Order*/Range routes and the Sanctum
decrypt (both CRT legs of a batch on the per-column-modulus kernels) —
and holds every CUDA kernel on them against its plain PyTorch version. Phases, each printing
one JSON line; any failure exits non-zero:

1. device     the card, from torch and nvidia-smi (a CUDA device is required);
2. build      nvcc for sm_90a of every kernel source (mont_mul, mont_exp,
              mont_prod3, mont_kfused, mont_redc, mont_k1, mont_rowmod), all started
              together, with each kernel's ptxas registers, stack, spills
              and shared memory; a spill in any of them (every one is a
              warp kernel on mont_warp.cuh) fails the phase;
3. parity     the Montgomery-multiply kernel against its plain version on
              the card at L = 256, B = 4096 (bit-exact), on column slices,
              at L = 33 and 512, on the carry-edge inputs (moduli of long
              0xFFFFFFFF runs; operands 0, 1, n - 1, R mod n, all-ones
              words) at L = 33, 256 and 512, and a K = 65,536 fold against
              the Python-int product mod n^2;
4. parity     (what = "karatsuba") B4, mode 1's half sums and
              recombination (mont_k1.cu), B5 and the reduction against
              their plain versions at L = 256, B = 4,096 (bit-exact), on
              column slices (B4 also on row slices); on the carry-edge
              inputs: B4 at h = 9, 32, 128 and 256, the mode-1 launches at
              L = 64, 256 and 512, B5 at L = 36, 256 and 512 with the
              all-ones operand, the reduction at L = 33, 256 and 512 with
              the extreme T = 0, R - 1, R (n - 1), n R - 1; `mul` under k1
              (at L = 64, 256 and 512) and fused equal to mode 0; the
              K = 65,536 fold in each mode against Python; at L = 33 and
              36 the modes route to the CIOS kernel (the B4 / B5 counters
              do not move);
5. parity     (what = "nofinal") the no-finalize probe P against its plain
              version at L = 256, B = 8,192 (bit-exact), on column slices,
              at L = 33 and 512 and on the carry-edge inputs;
6. parity     (what = "exp") the modexp kernel against its plain ladder at
              L = 256, B = 256 with a 64-bit exponent (bit-exact, Montgomery
              domain), on a column slice, at L = 512 and on the carry-edge
              bases (exponent 0xF0E1); a full-width pow_mod (exponent n,
              B = 8,192) against Python `pow` on 16 sampled rows; pow_mod
              at odd L = 33;
6b. parity    (what = "rowmod") the Sanctum decrypt's kernels
              (mont_rowmod.cu: the product and the ladder with one modulus
              and one exponent a column) against their plain versions,
              bit for bit: L = 128, B = 8,192 columns with two seeded
              2,048-bit moduli alternating by column block, then one
              modulus a column; digit columns of unequal lengths (leading
              zeros); L = 33 and 256; a carry-edge modulus a column at
              L = 33, 128 and 256; column slices;
7. timing     CUDA-event times of warmed folds at K = 65,536 and 8,192 and
              of one B = 4,096 launch, each beside the plain version's time
              and the least time the card could take (the bound); the
              K = 8,192 fold level by level (what = "fold_levels": each
              level's device ms, the host's dispatch ms for the fold);
8. timing     the K = 8,192 fold in each mode, and in modes 1 and 2 level
              by level (what = "fold_levels", mode = "k1" | "fused": each
              level's product (the three launches of `prod_k1`, or B5) and
              REDC device ms); one B = 4,096 launch of B4, of each mode-1
              launch around it, of B5 and of the reduction; `mul` and
              `mul_nofinal` at B = 8,192 and
              the finalize share (mul - nofinal) / mul, as
              benchmarks/profile_kernel.py prints it (P's own path: its
              counter is zeroed before and read after);
9. timing     (what = "exp") the B = 8,192, E = 512 pow_mod and its exp
              launch alone, beside the bound, the plain ladder on the same
              inputs (timed once, and bit-exact against the launch), and
              host Python `pow`;
10. crossover host Python-int fold vs resident device fold by width: the
              backend's `min_device_batch`;
11. e2e       boot the port's stack on `cuda` (min_device_batch = 0), load
              K = 8,192 rows by PutSet, check SumAll decrypts to the total
              and equals the Python-int fold, time sequential and
              concurrency-8 SumAll; then the same rounds under
              DDS_KARATSUBA=1 and =2, every result the mode-0 ciphertext.
              Launch counters are zeroed just before and read just after
              each mode, which must launch its own fold kernels and no
              others. Then, on the same stack and its K records, the
              analytics requests (benchmarks/analytics_matvec.py's R x K,
              16-bit weights) in modes 0, 1 and 2: MatVec (R = 16, D = 4
              digits), WeightedSum (one row) and GroupBySum (16 groups
              splitting the keys, D = 1), and in mode 0 a signed MatVec
              (R = 4, weights in (-2^16, 2^16): full-width n - |w|
              exponents, D = 512); each decrypting to W @ x, modes 1 and 2
              equal to mode 0, each mode's own kernels only, mode 0's
              mont_mul launches the ladders' count (88 a D = 4 request at
              K = 8,192, 9,232 the signed one); a 512-column slice against
              the host loop, bit for bit; the ladder alone, device and
              dispatch ms, beside its plain version and its bound;
12. coalesce  a fresh stack with K = 128 rows (below min_device_batch) and
              the 2 ms window: 3 rounds of 16 concurrent SumAlls, each
              decrypting to the total, at least one `fold_many` pass of 2 or
              more folds launching mont_mul; then the burst with the window
              off;
13. client    `run.load_provider` with `bulk-encrypt-backend = "cuda"`, then
              4 `DDSHttpClient`s each PutSet 2,048 rows (K = 8,192 in all)
              into a fresh stack: one bulk pre-pass per client, every PSSE
              ciphertext with its own fresh obfuscator; SumAll must decrypt
              to the column's total and equal the Python-int fold of the
              stored ciphertexts; the exp kernel's counter is zeroed just
              before and read just after and must be > 0;
13b. decrypt  benchmarks/decrypt_throughput.py's shape: at 1,024 and 2,048
              bits and B = 256, per-op `decrypt` on a slice,
              `decrypt_batch` on the host plan and the Sanctum device plan,
              each verified against the plaintexts before any timing; at
              2,048 bits the device plan at B = 4,096 and 8,192 (one and
              two chunks): decrypts/s, `kernel.sanctum_crt.*` spans, the
              host's marshal, limbs-to-ints and recombination ms a chunk,
              exactly 2 mont_mul_rowmod and 1 mont_exp_rowmod launches a
              chunk and no other kernel; each rowmod kernel at one chunk's
              8,192 columns beside its bound, its plain version once (the
              ladder on 64 columns), two shared-modulus mont_exp launches
              over test moduli as a yardstick; then `run.load_provider`
              with `[crypto] secret-device` and the client phase's keys,
              `HomoProvider.decrypt_rows` over its 8,192 stored rows read
              back by GetSet (every PSSE value its plaintext, a 64-row
              sample equal to the host plan, 2 + 1 launches a chunk);
              hygiene: no key's p, q, p^2 or q^2 in ModCtx.make's cache
              after three keys, one mont_rowmod build, scrub() closes
              every plan;
14. multall   BASELINE config 3 (benchmarks/product.py's K): a fresh stack
              (min_device_batch = 0) loads K = 16,384 one-column records of
              RSA-1024 ciphertexts by PutSet; in modes 0, 1 and 2, 6
              sequential and 3 rounds of 8 concurrent MultAlls, each equal
              to the Python-int product (mode 0's ciphertext) and decrypting
              to the plaintexts' product, each mode launching only its own
              fold kernels; then at L = 64 the fold level by level in each
              mode, one B = 4,096 launch of each fold kernel (bit-exact,
              held, beside its bound) and the crossover;
15. mixed     BASELINE config 5 (benchmarks/mixed.py --preload 4096
              --clients 4 --ops 200): 7 replicas, quorum 5; the preload's
              rows encrypted once; on crypto-backend cuda two stacks load
              them, the legacy one and one with [search], and the search
              phase runs on both (the "search" line, what = "rest"): the
              parity gate (one request to each of the twelve Search*,
              Order* and Range routes, paged, an Order column with ties;
              status and body equal), a write burst (64 PutSets, 8
              WriteElements, 8 RemoveSets to both; the indexed stack's
              write ingest off for it) and the gate again, which must
              repair the burst's keys (dds_search_index_total miss and
              stale), the warm query ms of each route on both paths with
              the spans a query, and search_latency.py's baseline (the
              legacy scan with the tag-validated cache off); then
              run_workload rounds (mixed.py's MIX, then
              configs/default.toml's mix) on both cuda stacks, and the
              MIX round on cpu (the baseline mixed.py prints), every
              client with no failed operation; on the legacy cuda stack
              the route sweep: every ported route against an answer
              recomputed on the host from the rows GetSet reads back;
    search    the search plane alone (what = "plane"): one GroupIndex on
              the card with 65,536 rows (one full resident pool's K) of
              packable OPE values with ties and DET labels; every eval_*
              equal to the plain Python reference; each pack's build ms,
              and each predicate op held on the lanes beside its bound
              (bytes) and the one PyTorch call on the folded column where
              one computes the same selection;
16. resident  the resident plane (configs/sharded.toml's [resident]: 4
              groups, max-rows 65,536, L = 256; benchmarks/resident_fold.py):
              for S = 1 and 4 groups and K = 8,192 and 65,536, cold (per-group
              marshaling) and warm (the fused fold) in modes 0, 1 and 2, each
              equal to the Python-int product, the fused tree's device and
              dispatch ms and its launches (one mont_mul a level: 14 at S = 4,
              K = 8,192); all 4 pools filled to max-rows (256 MiB), then one
              fold past the cap: one reset, still exact; a REST stack with
              [resident] on: SumAll in each mode through the plane, then 256
              PutSets ingested off the request path and a SumAll that ingests
              0 rows on the fold path; before those writes, one MatVec whose
              operands gather once through the plane's `rows_for`, equal to
              the marshaling path's weighted fold and decrypting to W @ x;
17. tiered    Stratum (configs/stratum.toml's [resident] and [storage],
              benchmarks/tiered_fold.py): 2 groups, max-rows 4,096, a
              population of 10 x max-rows per group, warm-bytes cut to
              max-rows x 10 x 16 (printed), the segment log in a temporary
              directory; the population fold and Zipf(0.9) folds over each
              group's 2,048-row head, exact, no reset, cold reads, the head's
              most drawn rows promoted back to hot; the all-resident ceiling
              against the tiered fold; one fold in modes 1 and 2; then a REST
              SumAll through a [resident] + [storage] stack;
18. kernels   one {"kernels": [...]} line (every kernel must have launched
              on its path; the fold kernels also carry their L = 64
              launch; the analytics requests' launches are the paths
              "analytics" and "analytics_rest", the rowmod kernels' the
              path "decrypt", `decrypt_rows`' run); then one {"search": ...}
              line: each predicate op's calls on the indexed stack (gates,
              timing and rounds), calls a query, held ms, bound and rows/s
              at 65,536 rows, each route's warm ms on both paths and the
              baseline, the rounds' ops/s on both stacks, the phase's and
              the run's seconds; then the card's name and power limit;
              then the result line.

    python3 chip_smoke.py              # on the card (needs one GPU)
    python3 chip_smoke.py --rehearse   # the same phases, tiny, on the CPU;
                                       # exits 3 and prints no result
    python3 chip_smoke.py --ab PARENT [--phases e2e,client,multall,mixed,resident,tiered]
        # on the card: another checkout (PARENT) against this one in turns,
        # parent, change, change, parent: the B1/P/B3/B4/B5/REDC kernel
        # times and the folds of every mode, or each tree's own chip_smoke
        # phases; prints no result line

Bound: one 4096-bit Montgomery product in W = 128 32-bit words is
2W^2 + W word products of 2 integer multiply-adds each; Hopper issues 64
such IMADs per SM per clock (half its FP32 FMA rate, which gives the
67 TFLOP/s float32 peak of NVIDIA's data sheet). The byte side counts each
input row read once and the output written once, at 3.35 TB/s. A modexp
row is 5E + 14 products in the exp kernel (the window table, then 4
squarings and 1 multiply per digit) and 5E + 16 in pow_mod. B4 and B5 are
3 (W/2)^2 word products a column, the reduction W^2 + W, so a Karatsuba
multiply is 28,800 against CIOS's 32,896 at W = 128. Mode 1's half sums
and recombination are adds, bound by bytes. The rowmod kernels count as
B1 and B3 at their L (128 for the decrypt), their bytes adding each
column's modulus words, n0inv and, for the ladder, R mod N and the digits. Every kernel runs one warp a
column on the same core.

On a card without the `cryptography` package the AES-backed columns (CHE,
None) run as the "Plain" null cipher in the client phase, the reference's
rule for AES-less hosts; the phase prints the schema it ran.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
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


def time_ms(fn, reps: int, warm: int, device, hold: bool = False) -> tuple[float, object]:
    """Mean ms per call: CUDA events around `reps` warmed calls on the card,
    the host clock on the CPU. With `hold` the stream is held
    (`torch.cuda._sleep`) while the host queues the calls, so a launch of a
    few tens of microseconds reads the device's time per call and not the
    host's time per wrapper call."""
    import torch

    out = None
    for _ in range(warm):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(50_000_000)  # ~25 ms: the host queues every call meanwhile
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


# the sources whose kernels must keep operands and accumulator in registers
# (the warp kernels of mont_warp.cuh)
NO_SPILL_SOURCES = tuple(f"dds_tpu_torch/csrc/{name}.cu" for name in (
    "mont_mul", "mont_exp", "mont_redc", "mont_kfused", "mont_prod3", "mont_k1",
    "mont_rowmod"))


def ptxas_report(log: str) -> dict:
    """{function: {registers, stack, spill_stores, spill_loads, smem}} from
    `nvcc -Xptxas -v` output: each figure goes to the function named by the
    last "Compiling entry function" / "Function properties for" line."""
    import re

    def readable(mangled: str) -> str:  # e.g. mont_mul_kernel<4, true>
        m = re.search(r"\d+(mont_\w+?_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
        if not m:
            return mangled
        args = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([ib])(\d+)E", m.group(2) or "")]
        return m.group(1) + (f"<{', '.join(args)}>" if args else "")

    funcs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", ln)
        if m:
            name = readable(m.group(1))
            funcs.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            funcs[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            funcs[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            funcs[name]["smem"] = int(sm.group(1)) if sm else 0
    return funcs


def phase_build(rehearse: bool) -> dict:
    from dds_tpu_torch.ops import mont_cuda

    if rehearse:
        emit("build", skipped="rehearsal: no nvcc on the CPU")
        return {}
    t = time.perf_counter()
    started = [k.start_build() for k in mont_cuda.KERNELS]  # one nvcc each, at once
    logs = [k.finish_build(*s) for k, s in zip(mont_cuda.KERNELS, started)]
    report = {source_path(k): ptxas_report(log) for k, log in zip(mont_cuda.KERNELS, logs)}
    emit("build", seconds=round(time.perf_counter() - t, 3),
         sources=[source_path(k) for k in mont_cuda.KERNELS], ptxas=report)
    spilled = {f: r for src in NO_SPILL_SOURCES for f, r in report[src].items()
               if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    if spilled:
        raise AssertionError(f"ptxas spilled registers of the warp kernels: {spilled}")
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
    wide = ModCtx.make(WIDE_MODULUS)
    wa = bn.to_device(residues(wide, 300, 3), dev).T.contiguous()
    wb = bn.to_device(residues(wide, 300, 4), dev).T.contiguous()
    if not torch.equal(mont_cuda.mul(wide, wa, wb), wide.mont_mul(wa.T, wb.T).T):
        raise AssertionError("mont_mul kernel != plain at L=512")
    edges = edge_parity(dev, lambda c, x, y: mont_cuda.mul(c, x, y, karatsuba=False),
                        lambda c, x, y: c.mont_mul(x.T, y.T).T, "mont_mul")
    K = sizes["K_big"]
    rows = residues(ctx, K, 5)
    t = time.perf_counter()
    fold = bn.limbs_to_int(bn.to_host(mont_cuda.reduce_mul(ctx, bn.to_device(rows, dev)))[0])
    fold_s = time.perf_counter() - t
    want_fold = host_product(bn.batch_to_ints(rows), ctx.n)
    if fold != want_fold:
        raise AssertionError(f"K={K} kernel fold != Python-int product mod n^2")
    emit("parity", L=ctx.L, B=B, max_abs_err=err, tolerance=0, slices=True,
         odd_L=odd.L, wide_L=wide.L, carry_edge_pairs=edges, carry_edge_L=EDGE_LS,
         fold_K=K, fold_equals_python_int=True,
         fold_first_call_s=round(fold_s, 3))
    return {"max_abs_err": err, "k_rows": (K, rows, want_fold)}


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
    K = sizes["K_path"]
    levels = fold_levels(ctx, bn.to_device(residues(ctx, K, 6 + K), dev), dev, 5)
    out["path"]["device_ms"] = levels["device_ms"]
    emit("timing", what="fold_levels", **levels)
    B = sizes["B"]
    a = bn.to_device(residues(ctx, B, 7), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, 8), dev).T.contiguous()
    ms, _ = time_ms(lambda: mont_cuda.mul(ctx, a, b), sizes["reps_path"], 2, dev, hold=True)
    pms, _ = time_ms(lambda: ctx.mont_mul(a.T, b.T), sizes["reps_plain"], 1, dev)
    imads = B * (2 * ctx.W * ctx.W + ctx.W) * 2
    bms, by = bound_ms(imads, 3 * B * ctx.L * 4, card["sms"], card["clock_mhz"])
    emit("timing", what="mul", L=ctx.L, B=B, ms=ms, plain_ms=pms, bound_ms=bms,
         bound_by=by, imads=imads)
    return out


def fold_levels(ctx, rows, dev, reps: int, mode=False) -> dict:
    """The K-row fold level by level, in mode 0 (`mode` False: one
    `mont_mul` launch a level), mode 1 ("k1": `karatsuba.prod_k1`, then a
    REDC launch) or mode 2 ("fused": a B5 then a REDC launch): each level's
    device ms (in modes 1 and 2 also its product's and its REDC's), and the
    host's dispatch ms for the whole fold (`reduce_mul` itself, not
    synchronised). The levels are `reduce_mul`'s, replayed with a CUDA
    event after each product and each REDC while the stream is held
    (`torch.cuda._sleep`) until the host has queued them all, so no level's
    time includes the host's gap before it; the replay must give
    `reduce_mul`'s result. Only public `mont_cuda` and `karatsuba` calls,
    so it times any tree's package. On the CPU (rehearsal) the marks are
    host clock readings."""
    import torch
    from dds_tpu_torch.ops import karatsuba, mont_cuda

    K, L = rows.shape
    P2 = 1 << max(1, (K - 1).bit_length())
    want = mont_cuda.reduce_mul(ctx, rows, karatsuba=mode)
    fix = ctx.fold_fix(K, dev)
    widths = [P2 >> i for i in range(1, P2.bit_length())] + [1]
    per_level_launches = 2 if mode else 1
    host, per_launch = [], []
    for _ in range(reps):
        sync(dev)
        t = time.perf_counter()
        mont_cuda.reduce_mul(ctx, rows, karatsuba=mode)
        host.append((time.perf_counter() - t) * 1e3)
        x = torch.empty((L, P2), dtype=torch.int32, device=dev)
        x[:, :K] = rows.T
        x[:, K:] = ctx.consts(dev)["one_mont"][:, None]
        sync(dev)
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(per_level_launches * len(widths) + 1)]
            marks = iter(events)
            mark = lambda: next(marks).record()
            # ~25 ms, ~200 ms in mode 1, where `--ab` also times trees whose
            # `prod_k1` is PyTorch ops: the host queues every level meanwhile
            torch.cuda._sleep(400_000_000 if mode == "k1" else 50_000_000)
        else:
            events = []
            mark = lambda: (sync(dev), events.append(time.perf_counter() * 1e3))

        def level(x, y):
            if not mode:
                x = mont_cuda.mul(ctx, x, y, karatsuba=False)
            else:
                T = karatsuba.prod_kf(x, y) if mode == "fused" else karatsuba.prod_k1(x, y)
                mark()
                x = mont_cuda.redc(ctx, T)
            mark()
            return x

        mark()
        for h in widths[:-1]:
            x = level(x[:, :h], x[:, h: 2 * h])
        x = level(x, fix)
        sync(dev)
        if dev.type == "cuda":
            per_launch.append([e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])])
        else:
            per_launch.append([t1 - t0 for t0, t1 in zip(events, events[1:])])
        if not torch.equal(x.T.contiguous(), want):
            raise AssertionError(f"K={K} fold replayed by level != reduce_mul")
    launches = [statistics.median(col) for col in zip(*per_launch)]
    levels = [sum(launches[i: i + per_level_launches])
              for i in range(0, len(launches), per_level_launches)]
    rec = {"K": K, "mode": mode or "cios", "widths": widths, "level_device_ms": levels,
           "device_ms": sum(levels), "host_dispatch_ms": statistics.median(host), "reps": reps}
    if mode:
        product = "kfused" if mode == "fused" else "prod_k1"
        rec[f"level_{product}_ms"], rec["level_redc_ms"] = launches[0::2], launches[1::2]
    return rec


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
    wide_base = torch.cat([base, base.flip(1)], dim=1)  # a column slice
    if not torch.equal(mont_cuda.exp(ctx, wide_base[:, Bs:], digits),
                       ctx.mont_exp(wide_base[:, Bs:].T, digits).T):
        raise AssertionError("exp kernel on a column slice != plain ladder")
    short = torch.from_numpy(_exp_to_digits(0xF0E1).astype(np.int32)).to(dev)
    wide = ModCtx.make(WIDE_MODULUS)
    wb = wide.to_mont(bn.to_device(residues(wide, 8, 36), dev)).T.contiguous()
    if not torch.equal(mont_cuda.exp(wide, wb, short), wide.mont_exp(wb.T, short).T):
        raise AssertionError(f"exp kernel != plain ladder at L={wide.L}")
    edges = edge_parity(dev, lambda c, x, _: mont_cuda.exp(c, x, short),
                        lambda c, x, _: c.mont_exp(x.T, short).T, "exp")

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
           "pow_equals_python": True, "odd_L": odd.L, "first_call_s": first_s,
           "slice": True, "wide_L": wide.L, "carry_edge_rows": edges,
           "carry_edge_L": EDGE_LS, "carry_edge_exponent": "0xF0E1"}
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


ROWMOD_LS = (33, 128, 256)  # W = 17, 64, 128: 1, 2 and 4 words per lane


def rowmod_inputs(moduli: list[int], L: int, seed: int, E: int, dev) -> tuple:
    """One column a modulus: limbs-major operands a, b below each column's
    modulus, (E, B) int32 MSB-first digit columns of unequal lengths
    (leading zeros) and the column constants `(N32, n0inv32, one_mont)`
    (`mont_cuda.rowmod_args`)."""
    import torch
    from dds_tpu_torch.ops import mont_cuda

    rng = np.random.default_rng(seed)
    B = len(moduli)
    a = [int.from_bytes(rng.bytes(2 * L), "little") % n for n in moduli]
    b = [int.from_bytes(rng.bytes(2 * L), "little") % n for n in moduli]
    a[0] = moduli[0] - 1
    lens = rng.integers(1, E + 1, size=B)
    digits = rng.integers(0, 16, size=(E, B)).astype(np.int32)
    digits[np.arange(E)[:, None] < (E - lens)[None, :]] = 0
    return (limbs_major(a, L, dev), limbs_major(b, L, dev),
            torch.from_numpy(digits).to(dev), mont_cuda.rowmod_args(moduli, L, dev))


def rowmod_parity(moduli: list[int], L: int, seed: int, E: int, dev, what: str) -> int:
    """Both per-column-modulus kernels against their plain versions on
    the same inputs (bit-exact); returns the largest |difference| (0)."""
    import torch
    from dds_tpu_torch.ops import mont_cuda

    a, b, D, (N32, n0, one) = rowmod_inputs(moduli, L, seed, E, dev)
    for name, got, want in (
            ("mul_rowmod", mont_cuda.mul_rowmod(a, b, N32, n0),
             mont_cuda.mul_rowmod_plain(a, b, N32, n0)),
            ("exp_rowmod", mont_cuda.exp_rowmod(a, D, one, N32, n0),
             mont_cuda.exp_rowmod_plain(a, D, one, N32, n0))):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} kernel != plain version ({what}, L={L}, "
                                 f"B={len(moduli)}): max |diff| {max_abs_diff(got, want)}")
    return 0


def phase_parity_rowmod(dev, sizes) -> dict:
    """The Sanctum decrypt's kernels (`csrc/mont_rowmod.cu`) against their
    plain versions on the card, bit for bit: at L = 128, B columns with two
    seeded 2,048-bit moduli alternating by column block (as the fused
    decrypt stacks p^2 and q^2), then one modulus a column; per-column
    digits of unequal lengths; column slices; L = 33 and 256; a different
    carry-edge modulus in every column at each L."""
    import torch
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import carry_edge_moduli

    t = time.perf_counter()
    B, E = sizes["rowmod_B"], sizes["rowmod_E"]
    rng = np.random.default_rng(70)

    def odd(L: int, count: int) -> list[int]:
        return [int.from_bytes(rng.bytes(2 * L), "little") | 1 | (1 << (16 * L - 1))
                for _ in range(count)]

    two = odd(128, 2)
    cases = [("two moduli by column block", 128, [two[0]] * (B // 2) + [two[1]] * (B // 2)),
             ("one modulus a column", 128, odd(128, B))]
    cases += [("odd and wide L", L, odd(L, 64)) for L in (33, 256)]
    cases += [("carry edges", L, (carry_edge_moduli(L) * 22)[:64]) for L in ROWMOD_LS]
    for i, (what, L, mods) in enumerate(cases):
        rowmod_parity(mods, L, 71 + i, E, dev, what)
    # column slices: the right half of a (L, 2B') array against the left
    mods = odd(128, 96)
    a, b, D, (N32, n0, one) = rowmod_inputs(mods, 128, 90, E, dev)
    wa, wD = torch.cat([a, a], dim=1), torch.cat([D, D], dim=1)
    if not (torch.equal(mont_cuda.mul_rowmod(wa[:, 96:], b, N32, n0),
                        mont_cuda.mul_rowmod(a, b, N32, n0))
            and torch.equal(mont_cuda.exp_rowmod(wa[:, 96:], wD[:, 96:], one, N32, n0),
                            mont_cuda.exp_rowmod(a, D, one, N32, n0))):
        raise AssertionError("a rowmod kernel on column slices != on contiguous columns")
    rec = {"B": B, "E": E, "Ls": sorted({L for _, L, _ in cases}),
           "cases": [{"what": w, "L": L, "B": len(m)} for w, L, m in cases],
           "slice": True, "max_abs_err": 0, "tolerance": 0,
           "seconds": time.perf_counter() - t}
    emit("parity", what="rowmod", **rec)
    return rec



ODD_MODULI = {33: (1 << 519) | 0x1F3 | (12345 << 200),   # L = 33: odd
              36: (1 << 575) | 0x2A5 | (6789 << 300)}    # L = 36: (L/2) % 8 != 0


def karatsuba_operands(ctx, B: int, seed: int, dev):
    """(a, b, s, the six B4 operands) at the fold's shape: two limbs-major
    (L, B) residue batches, their half sums s = [sa | sb | ca | cb] from the
    plain version, and B4's operands as row slices of a, b and s."""
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import montgomery

    a = bn.to_device(residues(ctx, B, seed), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, seed + 1), dev).T.contiguous()
    h = ctx.L // 2
    s = montgomery.k1_halfsums(a.T, b.T).T.contiguous()
    return a, b, s, (a[:h], b[:h], a[h:], b[h:], s[:h], s[h: 2 * h])


def max_abs_diff(x, y) -> int:
    return int((x.long() - y.long()).abs().max())


EDGE_LS = (33, 256, 512)  # W = 17, 128, 256: 1, 4 and 8 words per lane
KFUSED_EDGE_LS = (36, 256, 512)  # H = 9, 64, 128: 1, 2 and 4 words per lane
PROD3_EDGE_HS = (9, 32, 128, 256)  # B4: H = 5, 16, 64, 128: 1, 1, 2 and 4 words per lane
K1_EDGE_LS = (64, 256, 512)  # mode 1's launches: H = 16, 64, 128
WIDE_MODULUS = (1 << 8191) | (0x9E3779B97F4A7C15 << 4000) | 0x2B  # L = 512
# `mul` under k1 against mode 0 at L = 64 (RSA-1024, MultAll's width) and 512
K1_MUL_MODULI = ((1 << 1023) | (0x9E3779B97F4A7C15 << 500) | 0x3B, WIDE_MODULUS)
# every counter of the Karatsuba families' launches
KARATSUBA_KERNELS = ("mont_prod3", "mont_k1_halfsums", "mont_k1_combine", "mont_kfused",
                     "mont_redc")


def limbs_major(vals: list[int], rows: int, dev):
    """Limbs-major (rows, len(vals)) int32 of the ints on `dev`."""
    from dds_tpu_torch.ops import bignum as bn

    return bn.to_device(bn.ints_to_batch(vals, rows), dev).T.contiguous()


def pair_inputs(ctx, dev, operands=None) -> tuple:
    """(a, b): every ordered pair of `operands(ctx)` (default
    `montgomery.carry_edge_operands`), limbs-major on `dev`."""
    from dds_tpu_torch.ops.montgomery import carry_edge_operands

    ops = (operands or carry_edge_operands)(ctx)
    return (limbs_major([x for x in ops for _ in ops], ctx.L, dev),
            limbs_major([y for _ in ops for y in ops], ctx.L, dev))


def redc_inputs(ctx, dev) -> tuple:
    """(T,): the reduction's carry-edge inputs (`carry_edge_products`)."""
    from dds_tpu_torch.ops.montgomery import carry_edge_products

    return (limbs_major(carry_edge_products(ctx), 2 * ctx.L, dev),)


def edge_parity(dev, kernel, plain, what: str, Ls=EDGE_LS, inputs=pair_inputs) -> int:
    """`kernel(ctx, *args)` against `plain(ctx, *args)` (bit-exact) for
    every carry-edge modulus (`montgomery.carry_edge_moduli`) of each L in
    `Ls`, args = `inputs(ctx, dev)`; returns the columns checked."""
    import torch
    from dds_tpu_torch.ops.montgomery import ModCtx, carry_edge_moduli

    checked = 0
    for L in Ls:
        for n in carry_edge_moduli(L):
            ctx = ModCtx.make(n)
            args = inputs(ctx, dev)
            if not torch.equal(kernel(ctx, *args), plain(ctx, *args)):
                raise AssertionError(f"{what} kernel != plain on carry edges at L={L}, "
                                     f"n={hex(ctx.n)[:18]}...")
            checked += args[0].shape[1]
    return checked


def prod3_edge_parity(dev) -> int:
    """B4 against its plain version (bit-exact) on its carry-edge columns
    (`montgomery.prod3_edge_columns`) at each h of `PROD3_EDGE_HS`, a0/a1,
    b0/b1 and sa/sb passed as row slices of three (2h, B) tensors; returns
    the columns checked."""
    import torch
    from dds_tpu_torch.ops import mont_cuda, montgomery

    checked = 0
    for h in PROD3_EDGE_HS:
        cols = montgomery.prod3_edge_columns(h)
        # the columns are (a0, b0, a1, b1, sa, sb)
        a, b, s = (torch.cat([limbs_major([c[i] for c in cols], h, dev) for i in rows])
                   for rows in ((0, 2), (1, 3), (4, 5)))
        args = (a[:h], b[:h], a[h:], b[h:], s[:h], s[h:])
        if not torch.equal(mont_cuda.prod3(*args), montgomery.prod3(*(x.T for x in args)).T):
            raise AssertionError(f"mont_prod3 kernel != plain on carry edges at h={h}")
        checked += len(cols)
    return checked


def k1_combine_inputs(ctx, dev) -> tuple:
    """(z, s): B4's plain output and the plain half sums of every ordered
    pair of `montgomery.karatsuba_edge_operands`, the recombination's
    carry-edge inputs."""
    from dds_tpu_torch.ops import montgomery

    a, b = pair_inputs(ctx, dev, montgomery.karatsuba_edge_operands)
    h = ctx.L // 2
    s = montgomery.k1_halfsums(a.T, b.T)
    z = montgomery.prod3(a.T[:, :h], b.T[:, :h], a.T[:, h:], b.T[:, h:], s[:, :h],
                         s[:, h: 2 * h])
    return z.T.contiguous(), s.T.contiguous()


def phase_parity_karatsuba(ctx, dev, sizes, k_rows) -> dict:
    """B4, mode 1's half sums and recombination, B5 and the reduction
    against their plain versions on the card (bit-exact) at the fold's
    shape and on column slices (B4 also on row slices), then on the
    carry-edge inputs (B4 at h = 9, 32, 128 and 256, the mode-1 launches at
    L = 64, 256 and 512, B5 at L = 36, 256 and 512, the reduction at L = 33,
    256 and 512 with the extreme T), `mul` in each Karatsuba mode against
    mode 0 (k1 at L = 64, 256 and 512), a K-row fold in each mode against
    the Python-int product, and the shape rule: at L = 33 and 36 the modes
    route to the CIOS kernel."""
    import torch
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda, montgomery
    from dds_tpu_torch.ops.montgomery import ModCtx

    B, L, h = sizes["B"], ctx.L, ctx.L // 2
    a, b, s, ops = karatsuba_operands(ctx, B, 40, dev)
    kf = mont_cuda.prod_kf(a, b)
    z = mont_cuda.prod3(*ops)
    errs = {
        "mont_prod3": max_abs_diff(z, montgomery.prod3(*(x.T for x in ops)).T),
        "mont_k1_halfsums": max_abs_diff(mont_cuda.k1_halfsums(a, b), s),
        "mont_k1_combine": max_abs_diff(mont_cuda.k1_combine(z, s, L),
                                        montgomery.k1_combine(z.T, s.T, L).T),
        "mont_kfused": max_abs_diff(kf, montgomery.prod_kf(a.T, b.T).T),
    }
    T = montgomery.prod(a.T, b.T).T.contiguous()
    red = mont_cuda.redc(ctx, T)
    errs["mont_redc"] = max_abs_diff(red, ctx.redc(T.T).T)
    if any(errs.values()):
        raise AssertionError(f"Karatsuba kernels != plain at L={L}, B={B}: {errs}")
    wide = torch.cat([a, b], dim=1)  # column slices, as a fold level passes them
    xa, xb = wide[:, :B], wide[:, B:]
    if not torch.equal(mont_cuda.prod_kf(xa, xb), kf):
        raise AssertionError("mont_kfused kernel on column slices != contiguous operands")
    if not torch.equal(mont_cuda.k1_halfsums(xa, xb), s):
        raise AssertionError("mont_k1_halfsums kernel on column slices != contiguous operands")
    if not torch.equal(mont_cuda.prod3(xa[:h], xb[:h], xa[h:], xb[h:], *ops[4:]), z):
        raise AssertionError("mont_prod3 kernel on column slices != contiguous operands")
    zs = torch.cat([z.flip(1), z], dim=1)[:, B:]
    ss = torch.cat([s.flip(1), s], dim=1)[:, B:]
    if not torch.equal(mont_cuda.k1_combine(zs, ss, L), montgomery.k1_combine(z.T, s.T, L).T):
        raise AssertionError("mont_k1_combine kernel on column slices != contiguous inputs")
    if not torch.equal(mont_cuda.redc(ctx, torch.cat([T.flip(1), T], dim=1)[:, B:]), red):
        raise AssertionError("mont_redc kernel on a column slice != contiguous T")
    karatsuba_pairs = lambda c, d: pair_inputs(c, d, montgomery.karatsuba_edge_operands)
    edges = {
        "mont_prod3": prod3_edge_parity(dev),
        "mont_k1_halfsums": edge_parity(
            dev, lambda c, x, y: mont_cuda.k1_halfsums(x, y),
            lambda c, x, y: montgomery.k1_halfsums(x.T, y.T).T, "mont_k1_halfsums",
            K1_EDGE_LS, karatsuba_pairs),
        "mont_k1_combine": edge_parity(
            dev, lambda c, zz, sz: mont_cuda.k1_combine(zz, sz, c.L),
            lambda c, zz, sz: montgomery.k1_combine(zz.T, sz.T, c.L).T, "mont_k1_combine",
            K1_EDGE_LS, k1_combine_inputs),
        "mont_kfused": edge_parity(
            dev, lambda c, x, y: mont_cuda.prod_kf(x, y),
            lambda c, x, y: montgomery.prod_kf(x.T, y.T).T, "mont_kfused", KFUSED_EDGE_LS,
            karatsuba_pairs),
        "mont_redc": edge_parity(dev, mont_cuda.redc, lambda c, t: c.redc(t.T).T,
                                 "mont_redc", EDGE_LS, redc_inputs),
    }
    cios = mont_cuda.mul(ctx, a, b, karatsuba=False)
    for mode in ("k1", "fused"):
        if max_abs_diff(mont_cuda.mul(ctx, a, b, karatsuba=mode), cios):
            raise AssertionError(f"mul under {mode} != mul under mode 0")
    for n in K1_MUL_MODULI:
        other = ModCtx.make(n)
        oa = bn.to_device(residues(other, 300, 47), dev).T.contiguous()
        ob = bn.to_device(residues(other, 300, 48), dev).T.contiguous()
        if max_abs_diff(mont_cuda.mul(other, oa, ob, karatsuba="k1"),
                        mont_cuda.mul(other, oa, ob, karatsuba=False)):
            raise AssertionError(f"mul under k1 != mul under mode 0 at L={other.L}")
    K, rows, want = k_rows
    folds_s = {}
    for mode in (False, "k1", "fused"):
        t = time.perf_counter()
        got = mont_cuda.reduce_mul(ctx, bn.to_device(rows, dev), karatsuba=mode)
        if bn.limbs_to_int(bn.to_host(got)[0]) != want:
            raise AssertionError(f"K={K} fold under {mode or 'cios'} != Python-int product")
        folds_s[mode or "cios"] = time.perf_counter() - t
    routed = {}
    for L_odd, n in ODD_MODULI.items():
        odd = ModCtx.make(n)
        if odd.L != L_odd:
            raise AssertionError(f"modulus for L={L_odd} has L={odd.L}")
        oa = bn.to_device(residues(odd, 300, 41), dev).T.contiguous()
        ob = bn.to_device(residues(odd, 300, 42), dev).T.contiguous()
        ints = zip(bn.batch_to_ints(bn.to_host(oa.T)), bn.batch_to_ints(bn.to_host(ob.T)))
        Rinv = pow(odd.R, -1, n)
        want_odd = [x * y * Rinv % n for x, y in ints]
        before = {k: mont_cuda.LAUNCHES[k].value for k in KARATSUBA_KERNELS}
        for mode in ("k1", "fused"):
            got = bn.batch_to_ints(bn.to_host(mont_cuda.mul(odd, oa, ob, karatsuba=mode).T))
            if got != want_odd:
                raise AssertionError(f"mul under {mode} at L={L_odd} != Python")
        sync(dev)
        after = {k: mont_cuda.LAUNCHES[k].value for k in before}
        if after != before:
            raise AssertionError(f"L={L_odd} took the Karatsuba route: {before} -> {after}")
        routed[L_odd] = "cios"
    rec = {"L": L, "B": B, "max_abs_err": errs, "tolerance": 0, "slices": True,
           "carry_edge_columns": edges,
           "carry_edge_L": {"mont_prod3": [2 * x for x in PROD3_EDGE_HS],
                            "mont_k1": K1_EDGE_LS, "mont_kfused": KFUSED_EDGE_LS,
                            "mont_redc": EDGE_LS},
           "modes_equal_cios": True, "k1_equal_cios_L": sorted(
               [L] + [ModCtx.make(n).L for n in K1_MUL_MODULI]),
           "fold_K": K, "fold_equals_python_int": True,
           "fold_first_call_s": folds_s, "shape_rule": routed}
    emit("parity", what="karatsuba", **rec)
    return rec


def phase_parity_nofinal(ctx, dev, sizes) -> dict:
    """P against its plain version at profile_kernel.main's shape."""
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda

    B = sizes["B_probe"]
    a = bn.to_device(residues(ctx, B, 43), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, 44), dev).T.contiguous()
    err = max_abs_diff(mont_cuda.mul_nofinal(ctx, a, b), ctx.mont_mul_nofinal(a.T, b.T).T)
    if err:
        raise AssertionError(f"mont_mul_nofinal kernel != plain at L={ctx.L}, B={B}: {err}")
    import torch
    from dds_tpu_torch.ops.montgomery import ModCtx

    x = torch.cat([a, b], dim=1)  # column slices, as a fold level passes them
    if not torch.equal(mont_cuda.mul_nofinal(ctx, x[:, :B], x[:, B:]),
                       mont_cuda.mul_nofinal(ctx, a, b)):
        raise AssertionError("mont_mul_nofinal kernel on column slices != contiguous")
    for other in (ModCtx.make(ODD_MODULI[33]), ModCtx.make(WIDE_MODULUS)):
        oa = bn.to_device(residues(other, 300, 45), dev).T.contiguous()
        ob = bn.to_device(residues(other, 300, 46), dev).T.contiguous()
        if not torch.equal(mont_cuda.mul_nofinal(other, oa, ob),
                           other.mont_mul_nofinal(oa.T, ob.T).T):
            raise AssertionError(f"mont_mul_nofinal kernel != plain at L={other.L}")
    edges = edge_parity(dev, mont_cuda.mul_nofinal,
                        lambda c, x, y: c.mont_mul_nofinal(x.T, y.T).T, "mont_mul_nofinal")
    emit("parity", what="nofinal", L=ctx.L, B=B, max_abs_err=err, tolerance=0, slices=True,
         other_L=[33, 512], carry_edge_pairs=edges, carry_edge_L=EDGE_LS)
    return {"max_abs_err": err}


def word_products(ctx, kind: str) -> int:
    """32-bit word multiply-adds per column: a CIOS product (also P's loop),
    B4's three half products, B5 (the same three; its sums and
    recombination are adds), the reduction."""
    W, H = ctx.W, ctx.W // 2
    return {"cios": 2 * W * W + W, "prod3": 3 * H * H, "kfused": 3 * H * H,
            "redc": W * W + W}[kind]


def launch_table(ctx, B: int, seed: int, dev) -> dict:
    """One launch of each fold kernel at the fold's shape (L = ctx.L, B
    columns): name -> (kernel call, plain call, word multiply-adds a
    column, int32 rows moved a column: inputs read once, the output written
    once). The Karatsuba kernels' inputs come from plain versions on the
    card: B4's from the plain half sums, the recombination's from the plain
    B4, the reduction's from the plain full product."""
    from dds_tpu_torch.ops import mont_cuda, montgomery

    a, b, s, ops = karatsuba_operands(ctx, B, seed, dev)
    z = montgomery.prod3(*(x.T for x in ops)).T.contiguous()
    T = montgomery.prod(a.T, b.T).T.contiguous()
    L, h = ctx.L, ctx.L // 2
    return {
        "mont_mul": (lambda: mont_cuda.mul(ctx, a, b, karatsuba=False),
                     lambda: ctx.mont_mul(a.T, b.T).T,
                     word_products(ctx, "cios"), 3 * L),
        "mont_prod3": (lambda: mont_cuda.prod3(*ops),
                       lambda: montgomery.prod3(*(x.T for x in ops)).T,
                       word_products(ctx, "prod3"), 12 * h),
        "mont_k1_halfsums": (lambda: mont_cuda.k1_halfsums(a, b),
                             lambda: montgomery.k1_halfsums(a.T, b.T).T,
                             0, 2 * L + 2 * h + 2),
        "mont_k1_combine": (lambda: mont_cuda.k1_combine(z, s, L),
                            lambda: montgomery.k1_combine(z.T, s.T, L).T,
                            0, 8 * h + 2 + 2 * L),
        "mont_kfused": (lambda: mont_cuda.prod_kf(a, b),
                        lambda: montgomery.prod_kf(a.T, b.T).T,
                        word_products(ctx, "kfused"), 4 * L),
        "mont_redc": (lambda: mont_cuda.redc(ctx, T), lambda: ctx.redc(T.T).T,
                      word_products(ctx, "redc"), 3 * L),
    }


def time_launch_table(ctx, dev, sizes, card, seed: int, skip=()) -> dict:
    """Each fold kernel's single B-column launch (`launch_table`) at
    ctx.L, but those named in `skip`: bit-exact against its plain version,
    its ms with the stream held, the plain version's ms and the bound."""
    B = sizes["B"]
    out = {}
    for name, (kernel, plain, products, rows_moved) in launch_table(ctx, B, seed, dev).items():
        if name in skip:
            continue
        err = max_abs_diff(kernel(), plain())
        if err:
            raise AssertionError(f"{name} kernel != plain at L={ctx.L}, B={B}: {err}")
        ms, _ = time_ms(kernel, sizes["reps_path"], 2, dev, hold=True)
        pms, _ = time_ms(plain, sizes["reps_plain"], 1, dev)
        nbytes = rows_moved * B * 4
        bms, by = bound_ms(B * products * 2, nbytes, card["sms"], card["clock_mhz"])
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by}
        emit("timing", what=name, L=ctx.L, B=B, **out[name], bytes=nbytes)
    return out


def phase_timing_karatsuba(ctx, dev, sizes, card) -> dict:
    """CUDA-event times of the path-shaped fold in each mode (in modes 1
    and 2 also level by level), one launch of each fold kernel
    (`time_launch_table`: B4, mode 1's half sums and recombination, B5 and
    the reduction; B1's is `phase_timing`'s), and the finalize-share probe
    (mul against mul_nofinal), each beside its bound and its plain
    version's time."""
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda

    out = {"fold": {}}
    K, reps = sizes["K_path"], sizes["reps_path"]
    rows = bn.to_device(residues(ctx, K, 6 + K), dev)
    P2 = 1 << max(1, (K - 1).bit_length())
    for mode in (False, "k1", "fused"):
        ms, _ = time_ms(lambda: mont_cuda.reduce_mul(ctx, rows, karatsuba=mode), reps, 2, dev)
        per = (word_products(ctx, "cios") if not mode else
               word_products(ctx, "prod3") + word_products(ctx, "redc"))
        bms, by = bound_ms(P2 * per * 2, (K + 1) * ctx.L * 4, card["sms"], card["clock_mhz"])
        name = mode or "cios"
        out["fold"][name] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        emit("timing", what="fold_mode", mode=name, K=K, ms=ms, bound_ms=bms, bound_by=by,
             word_products_per_multiply=per, reps=reps)
    for mode in ("k1", "fused"):
        levels = fold_levels(ctx, rows, dev, 5, mode=mode)
        out["fold"][mode]["device_ms"] = levels["device_ms"]
        out["fold"][mode]["host_dispatch_ms"] = levels["host_dispatch_ms"]
        emit("timing", what="fold_levels", **levels)

    out.update(time_launch_table(ctx, dev, sizes, card, 50, skip=("mont_mul",)))

    # the finalize-share probe (profile_kernel.main): its own path, counted
    Bp = sizes["B_probe"]
    pa = bn.to_device(residues(ctx, Bp, 51), dev).T.contiguous()
    pb = bn.to_device(residues(ctx, Bp, 52), dev).T.contiguous()
    mont_cuda.nofinal_launches.reset()
    mul_ms, _ = time_ms(lambda: mont_cuda.mul(ctx, pa, pb, karatsuba=False), reps, 2, dev,
                        hold=True)
    nf_ms, _ = time_ms(lambda: mont_cuda.mul_nofinal(ctx, pa, pb), reps, 2, dev, hold=True)
    sync(dev)
    probe_launches = mont_cuda.nofinal_launches.value
    pms, _ = time_ms(lambda: ctx.mont_mul_nofinal(pa.T, pb.T), sizes["reps_plain"], 1, dev)
    bms, by = bound_ms(Bp * word_products(ctx, "cios") * 2, 3 * ctx.L * Bp * 4, card["sms"],
                       card["clock_mhz"])
    out["mont_mul_nofinal"] = {"ms": nf_ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                               "launches": probe_launches}
    emit("timing", what="finalize_share", L=ctx.L, B=Bp, mul_ms=mul_ms, nofinal_ms=nf_ms,
         finalize_share=(mul_ms - nf_ms) / mul_ms, nofinal_plain_ms=pms, bound_ms=bms,
         bound_by=by, nofinal_launches=probe_launches)
    return out


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_crossover(dev, modulus: int, widths) -> int:
    """Smallest width from which the resident device fold beats the host
    fold at every larger measured width, for folds mod `modulus`."""
    from dds_tpu_torch.models.backend import CudaBackend, _host_fold
    from dds_tpu_torch.ops.montgomery import ModCtx

    be = CudaBackend(device=dev, min_device_batch=0)
    rng = np.random.default_rng(9)
    nbytes = (modulus.bit_length() + 7) // 8
    table = []
    for K in widths:
        cs = [int.from_bytes(rng.bytes(nbytes), "little") % modulus for _ in range(K)]
        be.modmul_fold_resident(cs, modulus)  # ingest + build the row memo
        host, dvc = [], []
        for _ in range(5):
            t = time.perf_counter()
            h = _host_fold(cs, modulus)
            host.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            d = be.modmul_fold_resident(cs, modulus)
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
    emit("crossover", L=ModCtx.make(modulus).L, table=table, min_device_batch=cross)
    return cross


def reset_counts() -> None:
    from dds_tpu_torch.ops import mont_cuda

    for c in mont_cuda.LAUNCHES.values():
        c.reset()


def read_counts(dev) -> dict:
    from dds_tpu_torch.ops import mont_cuda

    sync(dev)
    return {k: c.value for k, c in mont_cuda.LAUNCHES.items()}


def paillier_rows(pk, K: int, seed: int) -> tuple[list, int]:
    """K PutSet rows of bft_sum's shape, the PSSE column (position 2) the
    encryptions of 1..K under seeded obfuscators; and the plaintext total."""
    rng = np.random.default_rng(seed)
    blinds = [pk.blind(int.from_bytes(rng.bytes(pk.n.bit_length() // 8 - 1), "little"))
              for _ in range(min(64, K))]
    rows = [[i, f"name-{i}", pk.encrypt(i + 1, rn=blinds[i % len(blinds)]),
             2, "a", "b", "c", "blob"] for i in range(K)]
    return rows, K * (K + 1) // 2


async def put_rows(port: int, rows: list) -> float:
    """PutSet every row (64 in flight); returns the seconds it took."""
    from dds_tpu_torch.http.miniserver import http_request

    sem = asyncio.Semaphore(64)

    async def put(r):
        async with sem:
            return await http_request("127.0.0.1", port, "POST", "/PutSet",
                                      json.dumps({"contents": r}).encode())

    t = time.perf_counter()
    statuses = await asyncio.gather(*(put(r) for r in rows))
    if not all(s == 200 for s, _ in statuses):
        raise AssertionError("PutSet failures during load")
    return time.perf_counter() - t


def aggregate_fn(port: int, target: str):
    """An async call of one aggregate route (`target`: path and query)
    that returns its ciphertext; a status other than 200 fails."""
    from dds_tpu_torch.http.miniserver import http_request

    async def aggregate() -> int:
        status, body = await http_request("127.0.0.1", port, "GET", target, timeout=300.0)
        if status != 200:
            raise AssertionError(f"{target.split('?')[0]} failed: {status} {body[:200]!r}")
        return int(json.loads(body)["result"])

    return aggregate


def sumall_fn(port: int, nsquare: int):
    return aggregate_fn(port, f"/SumAll?position={PSSE_POS}&nsqr={nsquare}")


# the kernels each DDS_KARATSUBA mode's SumAll must launch, and must not
MODE_KERNELS = {"0": {"mont_mul"},
                "1": {"mont_prod3", "mont_k1_halfsums", "mont_k1_combine", "mont_redc"},
                "2": {"mont_kfused", "mont_redc"}}
FOLD_KERNELS = ("mont_mul",) + KARATSUBA_KERNELS


def check_mode_launches(dev, counts: dict, mode: str, what: str) -> dict:
    """The fold kernels' counts of one mode's run; on the card each mode
    must have launched its own fold kernels and no others."""
    if dev.type == "cuda":
        ran = {k for k in FOLD_KERNELS if counts[k] > 0}
        if ran != MODE_KERNELS[mode]:
            raise AssertionError(f"{what}, DDS_KARATSUBA={mode}, launched {sorted(ran)}, "
                                 f"expected {sorted(MODE_KERNELS[mode])}: {counts}")
    return {k: counts[k] for k in FOLD_KERNELS}


async def phase_e2e(dev, sizes) -> dict:
    """The SumAll path at K rows: mode 0 (cold SumAll, then sequential and
    concurrency-8 rounds), then the same rounds on the same stack under
    DDS_KARATSUBA=1 and =2. Counts are zeroed before and read after each
    mode; each mode must launch its own fold kernels and no others."""
    import os

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K = sizes["K_path"]
    t = time.perf_counter()
    rows, total = paillier_rows(pk, K, 11)
    gen_s = time.perf_counter() - t

    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    # GroupBySum over every record names K SHA-512 keys: 1,073,152 bytes of
    # JSON at K = 8,192, past the default 1 MiB analytics body cap
    cfg.analytics.max_request_bytes = 2 << 20
    saved = os.environ.get("DDS_KARATSUBA")
    os.environ["DDS_KARATSUBA"] = "0"
    reset_counts()  # the main path's run starts here
    tracer.reset()
    dep = await launch(cfg)
    modes = {}
    try:
        port = dep.server.cfg.port
        put_s = await put_rows(port, rows)
        sumall = sumall_fn(port, pk.nsquare)
        t = time.perf_counter()
        result = await sumall()
        cold_s = time.perf_counter() - t
        if key.decrypt(result) != total:
            raise AssertionError("SumAll does not decrypt to the plaintext total")
        if result != host_product([r[PSSE_POS] for r in rows], pk.nsquare):
            raise AssertionError("SumAll != Python-int fold of the ciphertexts")

        for mode in ("0", "1", "2"):
            os.environ["DDS_KARATSUBA"] = mode
            if mode != "0":
                reset_counts()  # this mode's run starts here
            tracer.reset()
            seq = []
            for _ in range(sizes["requests"]):
                t = time.perf_counter()
                if await sumall() != result:
                    raise AssertionError(f"sequential SumAll changed (DDS_KARATSUBA={mode})")
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
                    raise AssertionError(f"concurrent SumAll changed (DDS_KARATSUBA={mode})")
            per_req = (time.perf_counter() - t) / (sizes["rounds"] * 8)
            # read just after this mode's run
            counts = check_mode_launches(dev, read_counts(dev), mode, "SumAll")
            sumalls = sizes["requests"] + 8 * sizes["rounds"] + (1 if mode == "0" else 0)
            best = min(min(seq), per_req)
            modes[mode] = {
                "adds_per_sec": (K - 1) / best,
                "sumall_ms_seq": min(seq) * 1e3,
                "sumall_ms_seq_median": statistics.median(seq) * 1e3,
                "sumall_ms_concurrent": per_req * 1e3,
                "phase_mean_ms": phases,
                "sumalls": sumalls,
                "launches": counts,
                "same_ciphertext_as_mode_0": True,
            }
        analytics = await phase_analytics(dev, sizes, port, key, rows)
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
        await dep.stop()
    m0 = modes["0"]
    rec = {
        "K": K, "key_bits": sizes["key_bits"], "replicas": 4, "quorum": 3,
        "adds_per_sec": m0["adds_per_sec"],
        "sumall_ms_seq": m0["sumall_ms_seq"],
        "sumall_ms_seq_median": m0["sumall_ms_seq_median"],
        "sumall_ms_concurrent": m0["sumall_ms_concurrent"],
        "sumall_ms_cold": cold_s * 1e3,
        "putset_ops_per_sec": K / put_s,
        "rows_gen_s": gen_s,
        "phase_mean_ms": m0["phase_mean_ms"],
        "sumalls": m0["sumalls"],
        "launches": m0["launches"]["mont_mul"],
        "launches_per_sumall": m0["launches"]["mont_mul"] / m0["sumalls"],
        "decrypt_ok": True,
        "karatsuba_modes": {m: modes[m] for m in ("1", "2")},
        "reduce_dispatch_ms": {m: modes[m]["phase_mean_ms"].get("kernel.store.reduce.dispatch")
                               for m in ("0", "1", "2")},
    }
    emit("e2e", **rec)
    rec["analytics"] = analytics
    return rec


def analytics_work(ctx, K: int, R: int, D: int) -> tuple[float, float]:
    """(integer multiply-adds, bytes) of one weighted fold of K operands,
    R rows and D digits: 15 P2 + D Rp (P2 + 4) + Rp CIOS products (the
    entry and the table over P2 columns; per digit 4 squarings over Rp,
    the tree's Rp (P2 - 1) and one multiply into the accumulator over Rp;
    the exit) of 2W^2 + W word products, 2 IMADs each; the K operand rows
    and the (D, P2 Rp) int32 gather index read once, R rows written."""
    P2 = 1 << max(0, (K - 1).bit_length())
    Rp = 1 << max(0, (R - 1).bit_length())
    products = 15 * P2 + D * Rp * (P2 + 4) + Rp
    return (products * (2 * ctx.W * ctx.W + ctx.W) * 2,
            (K * ctx.L + D * P2 * Rp + R * ctx.L) * 4)


def analytics_requests(keys: list, rng, R: int, signed: bool = False) -> dict:
    """The phase's requests over K columns: name -> (route, body, weight
    rows as the plaintext W). MatVec: R rows of 16-bit weights
    (analytics_matvec.py's default), or signed ones in (-2^16, 2^16);
    WeightedSum: one 16-bit row; GroupBySum: R groups that split the keys
    (0/1 selectors)."""
    K = len(keys)
    if signed:
        W = rng.integers(-(1 << 16) + 1, 1 << 16, size=(R, K)).tolist()
        return {"matvec_signed": ("MatVec", {"weights": W}, W)}
    W = rng.integers(0, 1 << 16, size=(R, K)).tolist()
    row = rng.integers(0, 1 << 16, size=K).tolist()
    groups = {f"g{g:02d}": keys[g::R] for g in range(R)}
    G = [[int(i % R == g) for i in range(K)] for g in range(R)]
    return {"matvec": ("MatVec", {"weights": W}, W),
            "weighted_sum": ("WeightedSum", {"weights": row}, [row]),
            "groupby": ("GroupBySum", {"groups": groups}, G)}


async def analytics_call(port: int, route: str, nsquare: int, body: dict) -> tuple[dict, float]:
    """One analytics request over the PSSE column; (answer, host ms)."""
    from dds_tpu_torch.http.miniserver import http_request

    data = json.dumps(body, separators=(",", ":")).encode()
    t = time.perf_counter()
    status, resp = await http_request("127.0.0.1", port, "POST",
                                      f"/{route}?position={PSSE_POS}&nsqr={nsquare}", data,
                                      timeout=300.0)
    ms = (time.perf_counter() - t) * 1e3
    if status != 200:
        raise AssertionError(f"/{route} failed: {status} {resp[:200]!r}")
    return json.loads(resp), ms


def analytics_results(answer: dict) -> list[int]:
    res = answer["result"]
    if isinstance(res, dict):
        return [int(res[g]) for g in sorted(res)]
    return [int(c) for c in (res if isinstance(res, list) else [res])]


async def phase_analytics(dev, sizes, port: int, key, rows) -> dict:
    """Prism on the e2e phase's stack, over its K stored Paillier-2048
    records (column PSSE_POS, plaintexts 1..K): in modes 0, 1 and 2, a
    MatVec of `analytics_R` rows of 16-bit weights (D = 4 digits), a
    WeightedSum of one such row and a GroupBySum of `analytics_R` groups
    splitting the keys (D = 1); then in mode 0 a signed MatVec of
    `analytics_signed_R` rows in (-2^16, 2^16), whose n - |w| exponents
    are full width (D = 512 at 2048 bits). Every result must decrypt to
    W @ x over the plaintexts, modes 1 and 2 must return mode 0's
    ciphertexts, each mode must launch its own fold kernels and no others
    (counts zeroed before and read after each mode), and mode 0's
    `mont_mul` launches must equal the ladders' 1 + 14 + D (4 + log2 P2 +
    1) + 1 each. Per request: the host ms, the
    `kernel.fold_weighted.{dispatch,execute}` ms, D, the launches, the
    gather's bytes. Then on a `analytics_slice`-column slice with R rows:
    the card's `fold_weighted` against the host loop `_host_matvec`, bit
    for bit, and the ladder alone with the stream held (device ms, host
    dispatch ms), beside its plain version (the same ladder on the plain
    PyTorch product, `ctx.mont_mul`, on the card) and beside its bound;
    and the ladder alone at the full K and at the signed request's shape,
    each with the stream held three times as long as it takes to queue."""
    import os

    import torch
    from dds_tpu_torch.models.backend import _host_matvec
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import foldmany, mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.utils import sigs
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    pk = key.public
    n2 = pk.nsquare
    ctx = ModCtx.make(n2)
    by_key = {sigs.key_from_set(r): (i + 1, r[PSSE_POS]) for i, r in enumerate(rows)}
    keys = sorted(by_key)
    xs = [by_key[k][0] for k in keys]
    cs = [by_key[k][1] for k in keys]
    K, R = len(keys), sizes["analytics_R"]
    rng = np.random.default_rng(21)
    requests = analytics_requests(keys, rng, R)
    requests_signed = analytics_requests(keys, rng, sizes["analytics_signed_R"], signed=True)
    P2 = 1 << max(0, (K - 1).bit_length())
    card = card_numbers(dev)
    out = {"K": K, "L": ctx.L, "requests": {}, "modes": {}}
    first = {}
    for mode in ("0", "1", "2"):
        os.environ["DDS_KARATSUBA"] = mode
        todo = dict(requests, **(requests_signed if mode == "0" else {}))
        reset_counts()  # this mode's requests start here
        expected = 0
        for name, (route, body, W) in todo.items():
            tracer.reset()
            answer, host_ms = await analytics_call(port, route, n2, body)
            if route != "GroupBySum" and answer["keys"] != keys:
                raise AssertionError(f"{name}: the echoed keys are not the sorted column")
            got = analytics_results(answer)
            want = [sum(w * x for w, x in zip(r, xs)) for r in W]
            if [key.decrypt_signed(c) for c in got] != want:
                raise AssertionError(f"{name} (DDS_KARATSUBA={mode}) does not decrypt to W @ x")
            if mode == "0":
                first[name] = got
            elif got != first[name]:
                raise AssertionError(f"{name} (DDS_KARATSUBA={mode}) != mode 0's ciphertexts")
            D = max(1, -(-max(w % pk.n for r in W for w in r).bit_length() // 4))
            launches = foldmany.fold_weighted_launches(K, D)
            expected += launches
            spans = tracer.summary()
            Rp = 1 << max(0, (len(W) - 1).bit_length())
            if mode == "0":
                imads, nbytes = analytics_work(ctx, K, len(W), D)
                bms, by = bound_ms(imads, nbytes, card["sms"], card["clock_mhz"])
                out["requests"][name] = {
                    "route": route, "R": len(W), "D": D, "mul_calls": launches,
                    "gather_bytes": ctx.L * P2 * Rp * 4, "table_bytes": 16 * ctx.L * P2 * 4,
                    "index_bytes": D * P2 * Rp * 4, "bound_ms": bms, "bound_by": by,
                    "host_ms": {}, "dispatch_ms": {}, "execute_ms": {}}
            rq = out["requests"][name]
            rq["host_ms"][mode] = host_ms
            rq["dispatch_ms"][mode] = spans["kernel.fold_weighted.dispatch"]["mean_ms"]
            rq["execute_ms"][mode] = spans["kernel.fold_weighted.execute"]["mean_ms"]
        counts = check_mode_launches(dev, read_counts(dev), mode, "analytics")
        # every `mul` is one launch of each of its mode's kernels
        if dev.type == "cuda" and any(counts[k] != expected for k in MODE_KERNELS[mode]):
            raise AssertionError(f"analytics DDS_KARATSUBA={mode}: {counts}, expected "
                                 f"{expected} launches of each of {sorted(MODE_KERNELS[mode])}")
        out["modes"][mode] = {"launches": counts, "expected_per_kernel": expected}
    os.environ["DDS_KARATSUBA"] = "0"

    # a slice against the host loop, and the ladder alone, timed
    S = min(sizes["analytics_slice"], K)
    W = requests["matvec"][2]
    sub = [r[:S] for r in W]
    got = foldmany.fold_weighted(cs[:S], sub, n2, device=dev)
    if got != _host_matvec(cs[:S], sub, n2):
        raise AssertionError(f"fold_weighted on a {S}-column slice != the host loop")
    timing = {}
    signed = [[w % pk.n for w in r] for r in requests_signed["matvec_signed"][2]]
    for width, cols, Wt in (("slice", S, W), ("full", K, W), ("signed", K, signed)):
        P2w = 1 << max(0, (cols - 1).bit_length())
        Rp = 1 << max(0, (len(Wt) - 1).bit_length())
        x = torch.zeros((ctx.L, P2w), dtype=torch.int32, device=dev)
        x[:, :cols] = bn.to_device(bn.ints_to_batch(cs[:cols], ctx.L), dev).T
        x[0, cols:] = 1
        idx = torch.from_numpy(foldmany._table_columns([r[:cols] for r in Wt], P2w, Rp)).to(dev)
        kernel = lambda: foldmany.weighted_ladder(
            ctx, x, idx, Rp, lambda a, b: mont_cuda.mul(ctx, a, b, False))
        kernel()
        sync(dev)
        t = time.perf_counter()
        kernel()
        queued_ms = (time.perf_counter() - t) * 1e3
        sync(dev)
        # hold the stream 3x as long as one call takes to queue, so the
        # events read the device alone; one call a hold, three holds
        cycles = max(100_000_000, int(3 * queued_ms * card["clock_mhz"] * 1e3))
        held = [held_ms(kernel, 1, dev, cycles) for _ in range(3)]
        dev_ms, dispatch_ms = min(h[0] for h in held), statistics.median(h[1] for h in held)
        imads, nbytes = analytics_work(ctx, cols, len(Wt), idx.shape[0])
        bms, by = bound_ms(imads, nbytes, card["sms"], card["clock_mhz"])
        rec = {"K": cols, "R": len(Wt), "D": idx.shape[0], "device_ms": dev_ms,
               "device_ms_runs": [h[0] for h in held], "dispatch_ms": dispatch_ms,
               "queued_ms": queued_ms,
               "hold_ms": cycles / (card["clock_mhz"] * 1e3), "bound_ms": bms,
               "bound_by": by, "launches": foldmany.fold_weighted_launches(cols, idx.shape[0])}
        if width == "slice":
            plain = lambda: foldmany.weighted_ladder(
                ctx, x, idx, Rp, lambda a, b: ctx.mont_mul(a.T, b.T).T.contiguous())
            t = time.perf_counter()
            pout = plain()
            sync(dev)
            rec["plain_ms"] = (time.perf_counter() - t) * 1e3
            if not torch.equal(pout, kernel()):
                raise AssertionError("the weighted ladder != its plain version")
            rec["max_abs_err"] = 0
        timing[width] = rec
    out["ladder"] = timing
    out["seconds"] = time.perf_counter() - t_phase
    emit("analytics", **out)
    return out


async def phase_coalesce(dev, sizes) -> dict:
    """The small-aggregate regime (BASELINE.md:107-114): a fresh stack
    with K rows, below min_device_batch, and the reference's 2 ms
    coalescing window. Rounds of concurrent SumAlls must each decrypt to
    the total, and at least one `fold_many` pass must carry two or more
    folds and launch mont_mul; then the same burst with the window off."""
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K, C = sizes["K_coalesce"], sizes["coalesce_burst"]
    rows, total = paillier_rows(pk, K, 12)
    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = sizes["coalesce_min_batch"]  # None: the measured 256
    dep = await launch(cfg)
    try:
        server = dep.server
        window = server.cfg.coalesce_window
        min_batch = server.backend.min_device_batch
        if K >= min_batch:
            raise AssertionError(f"K={K} is not below min_device_batch={min_batch}")
        await put_rows(server.cfg.port, rows)
        sumall = sumall_fn(server.cfg.port, pk.nsquare)
        if key.decrypt(await sumall()) != total:  # cold: fills the tag cache
            raise AssertionError("coalesce-phase SumAll does not decrypt to the total")

        async def timed() -> tuple[int, float]:
            t = time.perf_counter()
            r = await sumall()
            return r, time.perf_counter() - t

        async def burst() -> list[float]:
            got = await asyncio.gather(*(timed() for _ in range(C)))
            for r, _ in got:
                if key.decrypt(r) != total:
                    raise AssertionError("coalesced SumAll does not decrypt to the total")
            return [dt for _, dt in got]

        reset_counts()  # the coalesced path's run starts here
        tracer.reset()
        lat = []
        for _ in range(sizes["coalesce_rounds"]):
            lat += await burst()
        counts = read_counts(dev)
        spans = tracer.summary()
        groups = [e.meta["R"] for e in tracer.events("kernel.foldmany.execute")]
        multi = [r for r in groups if r >= 2]
        if not multi:
            raise AssertionError(f"no fold_many pass carried 2 or more folds: {groups}")
        if dev.type == "cuda" and counts["mont_mul"] <= 0:
            raise AssertionError("the coalesced fold never launched mont_mul")
        server.cfg.coalesce_window = 0.0
        lat_off = await burst()
    finally:
        await dep.stop()
    rec = {
        "K": K, "min_device_batch": min_batch, "window_s": window, "burst": C,
        "rounds": sizes["coalesce_rounds"], "decrypt_ok": True,
        "fold_many_passes": len(groups), "folds_per_pass": groups,
        "multi_fold_passes": len(multi), "mont_mul_launches": counts["mont_mul"],
        "coalesce_wait_mean_ms": spans.get("proxy.coalesce_wait", {}).get("mean_ms"),
        "coalesce_wait_count": spans.get("proxy.coalesce_wait", {}).get("count"),
        "coalesced_fold_mean_ms": spans.get("proxy.coalesced_fold", {}).get("mean_ms"),
        "request_ms_mean": statistics.mean(lat) * 1e3,
        "request_ms_median": statistics.median(lat) * 1e3,
        "window_off_request_ms_mean": statistics.mean(lat_off) * 1e3,
        "window_off_request_ms_median": statistics.median(lat_off) * 1e3,
    }
    emit("coalesce", **rec)
    return rec


def card_numbers(dev) -> dict:
    """The card's SM count and maximum SM clock, for the bounds (the H100's
    132 SMs and 1,980 MHz in a rehearsal on the CPU)."""
    import torch

    if dev.type != "cuda":
        return {"sms": 132, "clock_mhz": 1980.0}
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_mhz": float(nvidia_smi("clocks.max.sm").split()[0])}


def span_stats(prefixes: tuple) -> dict:
    """{span: {count, mean_ms, p95_ms}} of the tracer's spans whose names
    start with one of `prefixes`."""
    from dds_tpu_torch.utils.trace import tracer

    return {name: {k: v[k] for k in ("count", "mean_ms", "p95_ms")}
            for name, v in tracer.summary().items() if name.startswith(prefixes)}


async def phase_multall(dev, sizes) -> dict:
    """BASELINE config 3 (`benchmarks/product.py` at its default K)
    through the port's stack: a fresh 4-replica stack (quorum 3, f = 1,
    min_device_batch = 0) loads K one-column records of RSA-1024
    ciphertexts of distinct seeded plaintexts by concurrent PutSet; then in
    modes 0, 1 and 2 on the same stack a first MultAll, 6 sequential and 3
    rounds of 8 concurrent `GET /MultAll?position=0&pubkey=n`, each equal to
    the Python-int product mod n (so to mode 0's ciphertext) and decrypting
    to the plaintexts' product mod n. Counts are zeroed just before and
    read just after each mode, which must launch its own fold kernels and
    no others. Then at L = 64: the K-row fold level by level in each mode,
    one B-column launch of every fold kernel against its plain version and
    its bound, and the host/device crossover."""
    import os

    from dds_tpu_torch.models.mult import RsaMultKey
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    key = RsaMultKey.generate(sizes["rsa_bits"])
    n, K = key.n, sizes["K_multall"]
    ctx = ModCtx.make(n)
    rng = np.random.default_rng(13)
    plains = [int(m) + 2 for m in rng.choice(1 << 24, size=K, replace=False)]
    t = time.perf_counter()
    cts = [key.public.encrypt(m) for m in plains]
    enc_s = time.perf_counter() - t
    want, want_plain = host_product(cts, n), host_product(plains, n)
    if key.decrypt(want) != want_plain:
        raise AssertionError("the Python-int product does not decrypt to the plaintexts'")

    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    saved = os.environ.get("DDS_KARATSUBA")
    dep = await launch(cfg)
    modes = {}
    try:
        port = dep.server.cfg.port
        put_s = await put_rows(port, [[str(c)] for c in cts])
        multall = aggregate_fn(port, f"/MultAll?position=0&pubkey={n}")
        for mode in ("0", "1", "2"):
            os.environ["DDS_KARATSUBA"] = mode
            reset_counts()  # this mode's run starts here
            tracer.reset()
            t = time.perf_counter()
            if await multall() != want:
                raise AssertionError(f"MultAll != Python-int product (DDS_KARATSUBA={mode})")
            first_s = time.perf_counter() - t
            seq = []
            for _ in range(sizes["requests"]):
                t = time.perf_counter()
                if await multall() != want:
                    raise AssertionError(f"sequential MultAll changed (DDS_KARATSUBA={mode})")
                seq.append(time.perf_counter() - t)
            t = time.perf_counter()
            for _ in range(sizes["rounds"]):
                got = await asyncio.gather(*(multall() for _ in range(8)))
                if any(g != want for g in got):
                    raise AssertionError(f"concurrent MultAll changed (DDS_KARATSUBA={mode})")
            per_req = (time.perf_counter() - t) / (sizes["rounds"] * 8)
            # read just after this mode's run
            counts = check_mode_launches(dev, read_counts(dev), mode, "MultAll")
            best = min(min(seq), per_req)
            modes[mode] = {
                "ops_per_sec": (K - 1) / best,
                "multall_ms_first": first_s * 1e3,
                "multall_ms_seq": min(seq) * 1e3,
                "multall_ms_seq_median": statistics.median(seq) * 1e3,
                "multall_ms_concurrent": per_req * 1e3,
                "multalls": 1 + sizes["requests"] + 8 * sizes["rounds"],
                "launches": counts,
                "spans": span_stats(("http.", "proxy.", "abd.", "kernel.")),
            }
        pools = sorted(ModCtx.make(m).L for m in dep.server.backend._stores)
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
        await dep.stop()
    if pools != [ctx.L]:
        raise AssertionError(f"MultAll folded in pools of L={pools}, expected [{ctx.L}]")
    rec = {"K": K, "L": ctx.L, "key_bits": sizes["rsa_bits"], "replicas": 4, "quorum": 3,
           "putset_ops_per_sec": K / put_s, "encrypt_s": enc_s,
           "decrypts_to_product": True, "modes_equal_mode_0": True, "modes": modes}
    emit("multall", **rec)

    rows = bn.to_device(bn.ints_to_batch(cts, ctx.L), dev)
    rec["fold_levels"] = {}
    for mode in (False, "k1", "fused"):
        levels = fold_levels(ctx, rows, dev, 5, mode=mode)
        rec["fold_levels"][mode or "cios"] = levels
        emit("timing", what="fold_levels", L=ctx.L, **levels)
    rec["launches_L64"] = time_launch_table(ctx, dev, sizes, card_numbers(dev), 60)
    rec["crossover"] = phase_crossover(dev, n, sizes["crossover_l64"])
    return rec


# benchmarks/mixed.py's MIX (:33-39) and configs/default.toml's
# [client.proportions] (:87-96), copied: this script imports nothing of the
# reference (tests/test_torch_client.py holds the copies equal)
MIXED_MIX = {"put-set": 0.2, "search-gt": 0.1, "search-gteq": 0.1, "search-lt": 0.1,
             "search-lteq": 0.1, "sum-all": 0.2, "get-set": 0.1, "search-eq": 0.1}
DEFAULT_TOML_MIX = {"put-set": 0.2, "get-set": 0.1, "sum": 0.1, "sum-all": 0.1,
                    "mult-all": 0.1, "search-eq": 0.1, "search-gt": 0.1, "order-ls": 0.1,
                    "search-entry": 0.1}


def encrypt_rows(provider, schema: list, first: int, count: int) -> list:
    """`benchmarks/mixed.py::_preload`'s rows first..first+count-1: the
    canonical 8 columns, each encrypted with its schema tag, the PSSE
    column with pooled seeded obfuscators. Encrypted once, so every stack
    that loads them holds the same keys (keys are content hashes, and the
    random-IV column would otherwise differ)."""
    pk = provider.keys.psse.public
    rng = np.random.default_rng(14)
    blinds = [pk.blind(int.from_bytes(rng.bytes(pk.n.bit_length() // 8 - 1), "little"))
              for _ in range(32)]

    def enc_row(i: int) -> list:
        vals = [i, f"name-{i}", None, 2, "a", "b", "c", f"blob-{i}"]
        row = [provider.encrypt(v, tag) if v is not None else None
               for v, tag in zip(vals, schema)]
        row[PSSE_POS] = str(pk.encrypt(i, rn=blinds[i % 32]))  # PSSE, pooled
        return row

    return [enc_row(i) for i in range(first, first + count)]


async def preload(port: int, rows: list, first: int = 0) -> dict:
    """`benchmarks/mixed.py::_preload`: the encrypted rows through PutSet
    (64 in flight); returns {record key: first + row index}."""
    from dds_tpu_torch.http.miniserver import http_request

    sem = asyncio.Semaphore(64)

    async def put(i, row):
        async with sem:
            st, body = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                          json.dumps({"contents": row}).encode())
        if st != 200:
            raise AssertionError(f"preload PutSet failed: {st}")
        return body.decode(), first + i

    return dict(await asyncio.gather(*(put(i, r) for i, r in enumerate(rows))))


async def route_sweep(port: int, stored: list, keys, schema: list, preloaded: dict) -> dict:
    """One request to every ported route over the loaded stack, each held
    against an answer recomputed on the host from the rows read back by
    GetSet: keysets equal, SumAll and MultAll equal to the Python-int fold
    of the column and decrypting to the fold of its plaintexts, the pair
    aggregates likewise; element reads and writes, RemoveSet, paging, 404
    and 400 cases. Returns the checks made by route."""
    from dds_tpu_torch.http.miniserver import http_request

    async def call(method, target, obj=None):
        body = json.dumps(obj).encode() if obj is not None else None
        return await http_request("127.0.0.1", port, method, target, body, timeout=300.0)

    sem = asyncio.Semaphore(64)

    async def get(k):
        async with sem:
            st, body = await call("GET", f"/GetSet/{k}")
        if st != 200:
            raise AssertionError(f"GetSet {k}: {st}")
        return k, json.loads(body)["contents"]

    pairs = sorted(await asyncio.gather(*(get(k) for k in sorted(stored))))
    checks = {}

    def expect(route, got, want):
        if got != want:
            raise AssertionError(f"route sweep: {route} != host recomputation")
        checks[route] = checks.get(route, 0) + 1

    def keyset(resp):
        st, body = resp
        if st != 200:
            raise AssertionError(f"search failed: {st} {body[:200]!r}")
        return json.loads(body)["keyset"]

    def result(resp):
        st, body = resp
        if st != 200:
            raise AssertionError(f"aggregate failed: {st} {body[:200]!r}")
        return int(json.loads(body)["result"])

    psse, mse = keys.psse, keys.mse
    nsqr, n = psse.public.nsquare, mse.n
    col = lambda pos: [(k, v) for k, v in pairs if pos < len(v)]
    # the plaintexts: the preload's are known, the clients' rows decrypt
    others = [v for k, v in col(PSSE_POS) if k not in preloaded]
    psse_plain = [preloaded[k] for k, _ in col(PSSE_POS) if k in preloaded] + \
        psse.decrypt_batch([int(v[PSSE_POS]) for v in others])
    mse_plain = [2 if k in preloaded else mse.decrypt(int(v[3])) for k, v in col(3)]
    sumall = result(await call("GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}"))
    expect("SumAll", sumall, host_product([int(v[PSSE_POS]) for _, v in col(PSSE_POS)], nsqr))
    expect("SumAll", psse.decrypt(sumall), sum(psse_plain) % psse.n)
    multall = result(await call("GET", f"/MultAll?position=3&pubkey={n}"))
    expect("MultAll", multall, host_product([int(v[3]) for _, v in col(3)], n))
    expect("MultAll", mse.decrypt(multall), host_product(mse_plain, n))
    (k1, v1), (k2, v2) = pairs[len(pairs) // 3], pairs[2 * len(pairs) // 3]
    expect("Sum", result(await call(
        "GET", f"/Sum?key1={k1}&key2={k2}&position={PSSE_POS}&nsqr={nsqr}")),
        int(v1[PSSE_POS]) * int(v2[PSSE_POS]) % nsqr)
    expect("Mult", result(await call(
        "GET", f"/Mult?key1={k1}&key2={k2}&position=3&pubkey={n}")),
        int(v1[3]) * int(v2[3]) % n)

    def order(pos, desc):
        rows = [(int(v[pos]), k) for k, v in pairs if pos < len(v)]
        return [k for _, k in sorted(rows, key=lambda t: t[0], reverse=desc)]

    expect("OrderLS", keyset(await call("GET", "/OrderLS?position=0")), order(0, True))
    expect("OrderSL", keyset(await call("GET", "/OrderSL?position=0")), order(0, False))
    expect("OrderSL", keyset(await call("GET", "/OrderSL?position=0&offset=100&limit=50")),
           order(0, False)[100:150])
    enc = lambda v, pos: keys.ope.encrypt(v) if pos == 0 else (
        keys.che.encrypt(v) if schema[pos] == "CHE" else str(v))
    item = enc("name-5", 1)
    eq = [k for k, v in pairs if len(v) > 1 and str(v[1]) == item]
    expect("SearchEq", keyset(await call("POST", "/SearchEq?position=1", {"value": item})), eq)
    neq = [k for k, v in pairs if len(v) > 1 and str(v[1]) != item]
    expect("SearchNEq", keyset(await call("POST", "/SearchNEq?position=1&offset=10&limit=20",
                                          {"value": item})), neq[10:30])
    pivot = keys.ope.encrypt(2048)
    for route, op in (("SearchGt", lambda e: e > pivot), ("SearchGtEq", lambda e: e >= pivot),
                      ("SearchLt", lambda e: e < pivot), ("SearchLtEq", lambda e: e <= pivot)):
        want = [k for k, v in pairs if op(int(v[0]))]
        expect(route, keyset(await call("POST", f"/{route}?position=0", {"value": pivot})),
               want)
    lo, hi = keys.ope.encrypt(100), keys.ope.encrypt(1000)
    expect("Range", keyset(await call("POST", "/Range?position=0",
                                      {"value1": lo, "value2": hi})),
           [k for k, v in pairs if lo <= int(v[0]) <= hi])
    words = [enc(w, 4) for w in ("a", "name-7", "nowhere")]
    has = lambda v, w: any(str(e) == w for e in v)
    expect("SearchEntry", keyset(await call("POST", "/SearchEntry", {"value": words[1]})),
           [k for k, v in pairs if has(v, words[1])])
    triple = {"value1": words[0], "value2": words[1], "value3": words[2]}
    expect("SearchEntryOR", keyset(await call("POST", "/SearchEntryOR", triple)),
           [k for k, v in pairs if any(has(v, w) for w in words)])
    expect("SearchEntryAND", keyset(await call("POST", "/SearchEntryAND", triple)),
           [k for k, v in pairs if all(has(v, w) for w in words)])

    # element routes on a fresh record, then RemoveSet: SumAll is back
    fresh = [keys.ope.encrypt(7), enc("fresh", 1), str(psse.public.encrypt(5)),
             str(mse.public.encrypt(3))]
    st, body = await call("POST", "/PutSet", {"contents": fresh})
    fk = body.decode()
    expect("PutSet", st, 200)
    expect("SumAll", psse.decrypt(result(await call(
        "GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}"))), (sum(psse_plain) + 5) % psse.n)
    st, body = await call("GET", f"/ReadElement/{fk}?position=1")
    expect("ReadElement", (st, json.loads(body)), (200, {"value": fresh[1]}))
    expect("ReadElement", (await call("GET", f"/ReadElement/{fk}?position=4"))[0], 404)
    st, body = await call("POST", f"/IsElement/{fk}", {"value": fresh[1]})
    expect("IsElement", (st, json.loads(body)), (200, {"result": True}))
    expect("AddElement", (await call("PUT", f"/AddElement/{fk}", {"value": "tail"}))[0], 200)
    expect("WriteElement", (await call("PUT", f"/WriteElement/{fk}?position=9",
                                       {"value": "end"}))[0], 200)
    expect("WriteElement", (await call("PUT", f"/WriteElement/{fk}?position=1",
                                       {"value": "x"}))[0], 200)
    st, body = await call("GET", f"/GetSet/{fk}")
    expect("GetSet", (st, json.loads(body)["contents"]), (200, fresh[:1] + ["x"] + fresh[2:]
                                                          + ["tail", "end"]))
    expect("RemoveSet", (await call("DELETE", f"/RemoveSet/{fk}"))[0], 200)
    expect("GetSet", (await call("GET", f"/GetSet/{fk}"))[0], 404)
    expect("SumAll", result(await call("GET", f"/SumAll?position={PSSE_POS}&nsqr={nsqr}")),
           sumall)
    expect("Sum", (await call("GET", f"/Sum?key1={k1}&key2={fk}&position=2&nsqr={nsqr}"))[0],
           404)
    expect("OrderLS", (await call("GET", "/OrderLS?position=-1"))[0], 400)
    expect("OrderLS", (await call("GET", "/OrderLS?position=1"))[0], 400)  # not an int
    expect("SearchGt", (await call("POST", "/SearchGt?position=0&offset=-1",
                                   {"value": pivot}))[0], 400)
    return checks


SEARCH_ROUTES = ("OrderLS", "OrderSL", "SearchEq", "SearchNEq", "SearchGt", "SearchGtEq",
                 "SearchLt", "SearchLtEq", "Range", "SearchEntry", "SearchEntryOR",
                 "SearchEntryAND")
# the predicate ops of ops/predicate.py, by the `op` meta of their
# kernel.predicate spans, and each function's line in the reference
PREDICATE_OPS = {"compare_mask": (("gt", "ge", "lt", "le"), "dds_tpu/ops/predicate.py:104"),
                 "range_mask": (("range",), "dds_tpu/ops/predicate.py:135"),
                 "eq_mask": (("eq",), "dds_tpu/ops/predicate.py:163"),
                 "entry_mask": (("entry_any", "entry_all"), "dds_tpu/ops/predicate.py:185"),
                 "sort_perm": (("sort_asc", "sort_desc"), "dds_tpu/ops/predicate.py:228")}


def search_requests(keys, schema: list, tied_pos: int) -> list:
    """(route, method, target, body) of one request to each of the twelve
    Search*, Order* and Range routes over the mixed cell's rows, with
    offset/limit paging and Order over `tied_pos`, a column with ties."""
    che = (lambda s: keys.che.encrypt(s)) if schema[1] == "CHE" else str
    ope = keys.ope.encrypt
    pivot = {"value": ope(2048)}
    words = [che(w) for w in ("a", "name-7", "nowhere")]
    return [("OrderLS", "GET", "/OrderLS?position=0&offset=100&limit=50", None),
            ("OrderSL", "GET", f"/OrderSL?position={tied_pos}&offset=7&limit=300", None),
            ("SearchEq", "POST", "/SearchEq?position=1", {"value": che("name-5")}),
            ("SearchNEq", "POST", "/SearchNEq?position=1&offset=10&limit=20",
             {"value": che("name-5")}),
            ("SearchGt", "POST", "/SearchGt?position=0", pivot),
            ("SearchGtEq", "POST", "/SearchGtEq?position=0&limit=64", pivot),
            ("SearchLt", "POST", "/SearchLt?position=0", pivot),
            ("SearchLtEq", "POST", "/SearchLtEq?position=0&offset=5", pivot),
            ("Range", "POST", "/Range?position=0", {"value1": ope(100), "value2": ope(1000)}),
            ("SearchEntry", "POST", "/SearchEntry", {"value": words[1]}),
            ("SearchEntryOR", "POST", "/SearchEntryOR",
             {"value1": words[0], "value2": words[1], "value3": words[2]}),
            ("SearchEntryAND", "POST", "/SearchEntryAND",
             {"value1": words[0], "value2": che("b"), "value3": words[1]})]


async def rest_call(port: int, method: str, target: str, obj=None) -> tuple[int, bytes]:
    from dds_tpu_torch.http.miniserver import http_request

    body = json.dumps(obj).encode() if obj is not None else None
    return await http_request("127.0.0.1", port, method, target, body, timeout=300.0)


def index_outcomes() -> dict:
    from dds_tpu_torch.obs.metrics import metrics

    return {o: metrics.value("dds_search_index_total", outcome=o) or 0
            for o in ("hit", "stale", "miss")}


async def parity_gate(legacy_port: int, indexed_port: int, requests: list) -> dict:
    """Every request on both stacks: status and body must be equal. Returns
    each route's keyset size, the index outcomes the gate caused and the
    predicate ops it called."""
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.utils.trace import tracer

    tracer.reset(max_events=1 << 21)
    before = index_outcomes()
    paths0 = {r: metrics.value("dds_search_requests_total", route=r, path="indexed") or 0
              for r in SEARCH_ROUTES}
    sizes = {}
    for route, method, target, obj in requests:
        legacy = await rest_call(legacy_port, method, target, obj)
        indexed = await rest_call(indexed_port, method, target, obj)
        if legacy != indexed or legacy[0] != 200:
            raise AssertionError(f"search parity gate: {route} differs between the legacy "
                                 f"and the indexed stack ({legacy[0]} / {indexed[0]})")
        sizes[route] = len(json.loads(indexed[1])["keyset"])
    taken = {r: (metrics.value("dds_search_requests_total", route=r, path="indexed") or 0)
             - paths0[r] for r in SEARCH_ROUTES}
    if any(v <= 0 for v in taken.values()):
        raise AssertionError(f"search routes that missed the indexed path: {taken}")
    after = index_outcomes()
    return {"keysets": sizes, "outcomes": {o: after[o] - before[o] for o in after},
            "predicate_calls": predicate_calls(tracer.events("kernel.predicate.dispatch"))}


async def write_burst(ports: list, provider, keys, schema: list, stored: list,
                      first: int, sizes) -> dict:
    """The same writes to every stack: PutSets of new rows, WriteElements
    of the OPE column of existing records (values that other records
    hold, so the column gets ties) and RemoveSets."""
    rng = np.random.default_rng(23)
    picks = [stored[int(i)] for i in rng.choice(len(stored), size=sizes["search_writes"]
                                                + sizes["search_removes"], replace=False)]
    writes, removes = picks[:sizes["search_writes"]], picks[sizes["search_writes"]:]
    rows = encrypt_rows(provider, schema, first, sizes["search_puts"])
    added = [await preload(port, rows, first) for port in ports]
    if any(a != added[0] for a in added):
        raise AssertionError("the burst's PutSets gave the stacks different keys")
    for j, k in enumerate(writes):
        body = {"value": keys.ope.encrypt(17 + j % 3)}
        for port in ports:
            st, _ = await rest_call(port, "PUT", f"/WriteElement/{k}?position=0", body)
            if st != 200:
                raise AssertionError(f"burst WriteElement failed: {st}")
    for k in removes:
        for port in ports:
            st, _ = await rest_call(port, "DELETE", f"/RemoveSet/{k}")
            if st != 200:
                raise AssertionError(f"burst RemoveSet failed: {st}")
    return {"puts": len(rows), "writes": len(writes), "removes": len(removes)}


def predicate_calls(events) -> dict:
    """Calls of each predicate op among `kernel.predicate.dispatch` spans."""
    ops = collections.Counter(e.meta.get("op") for e in events)
    return {name: sum(ops[o] for o in fam) for name, (fam, _) in PREDICATE_OPS.items()}


async def time_routes(port: int, requests: list, reps: int, prefixes: tuple,
                      warm: bool = True) -> dict:
    """Warm ms of each request (one call first unless `warm` is False, then
    `reps` timed), the spans under `prefixes` per timed query, and the
    predicate ops the route's queries called."""
    from dds_tpu_torch.utils.trace import tracer

    out = {}
    for route, method, target, obj in requests:
        tracer.reset(max_events=1 << 21)
        for _ in range(int(warm)):
            await rest_call(port, method, target, obj)
        mark = time.time()
        ms = []
        for _ in range(reps):
            t = time.perf_counter()
            st, _ = await rest_call(port, method, target, obj)
            ms.append((time.perf_counter() - t) * 1e3)
            if st != 200:
                raise AssertionError(f"{route}: {st}")
        spans = collections.defaultdict(lambda: {"count": 0.0, "ms": 0.0})
        for e in tracer.events():
            if e.kind == "span" and e.ts >= mark and e.name.startswith(prefixes):
                spans[e.name]["count"] += 1 / reps
                spans[e.name]["ms"] += e.dur_ms / reps
        out[route] = {"median_ms": statistics.median(ms), "min_ms": min(ms), "reps": reps,
                      "queries": reps + int(warm),
                      "per_query": dict(spans),
                      "predicate_calls": predicate_calls(
                          tracer.events("kernel.predicate.dispatch"))}
    return out


async def search_rest(dev, sizes, legacy, indexed, provider, keys, schema: list) -> dict:
    """The search phase's REST part on the mixed cell's two cuda stacks,
    loaded with the same encrypted rows: the parity gate over the twelve
    routes; the write burst (the indexed stack's write ingest off, so its
    index learns of the burst through the query's tag round, the repair
    path under test) and the gate again; then the warm query ms of each
    route on both paths, and the search_latency.py baseline (the legacy
    scan with the tag-validated cache off) over two of its four cases."""
    t0 = time.perf_counter()
    lp, ip = legacy.server.cfg.port, indexed.server.cfg.port
    plane = indexed.server._search
    if plane.device.type != dev.type:
        raise AssertionError(f"the search plane built on {plane.device}, not {dev}")
    rec = {"device": str(plane.device)}
    stored = sorted(legacy.server.stored_keys)
    if stored != sorted(indexed.server.stored_keys):
        raise AssertionError("the two stacks hold different keys")
    rec["gate_before"] = await parity_gate(lp, ip, search_requests(keys, schema, 3))
    indexed.server._search_write_ingest = False
    rec["burst"] = await write_burst([lp, ip], provider, keys, schema, stored,
                                     sizes["mixed_preload"], sizes)
    indexed.server._search_write_ingest = True
    after = search_requests(keys, schema, 0)  # the burst gave the OPE column ties
    rec["gate_after"] = await parity_gate(lp, ip, after)
    repaired = rec["gate_after"]["outcomes"]
    if repaired["miss"] < rec["burst"]["puts"] or repaired["stale"] < rec["burst"]["writes"]:
        raise AssertionError(f"the burst's keys were not repaired: {repaired}")
    reps = sizes["search_reps"]
    rec["indexed"] = await time_routes(ip, after, reps, (
        "proxy.search_eval", "kernel.predicate", "abd.read_tags", "abd.fetch"))
    rec["legacy"] = await time_routes(lp, after, reps, (
        "proxy.fetch_stored", "abd.read_tags", "abd.fetch"))
    # two of search_latency.py's four cases (gt, order): each cache-less
    # query takes 14-17 s on the card at this size, the same for all four
    base = [r for r in after if r[0] in ("SearchGt", "OrderLS")]
    pcfg = legacy.server.cfg
    budget = pcfg.request_budget
    pcfg.aggregate_cache = False
    try:
        # one query under the deployment's own budget: thousands of full
        # quorum reads may not fit in it (503); the timed queries then get
        # a budget long enough to finish, so the reading is the scan's cost
        t = time.perf_counter()
        st, _ = await rest_call(lp, *base[0][1:])
        rec["baseline_default_budget"] = {"route": base[0][0], "status": st, "budget_s": budget,
                                          "ms": (time.perf_counter() - t) * 1e3}
        pcfg.request_budget = sizes["search_baseline_budget"]
        rec["baseline_no_cache"] = await time_routes(lp, base, sizes["search_baseline_reps"],
                                                     ("proxy.fetch_stored", "abd.fetch"),
                                                     warm=False)
    finally:
        pcfg.aggregate_cache, pcfg.request_budget = True, budget
    rec["indexed_over_legacy"] = {r: rec["legacy"][r]["median_ms"] / rec["indexed"][r]["median_ms"]
                                  for r in rec["indexed"]}
    calls = collections.Counter()
    for part in (rec["gate_before"], rec["gate_after"], *rec["indexed"].values()):
        calls.update(part["predicate_calls"])
    rec["predicate_calls"] = dict(calls)
    rec["queries"] = 2 * len(SEARCH_ROUTES) + sum(t["queries"] for t in rec["indexed"].values())
    rec["stats"] = plane.stats()
    rec["seconds"] = time.perf_counter() - t0
    return rec


async def phase_mixed(dev, sizes) -> dict:
    """BASELINE config 5 (`benchmarks/mixed.py --preload 4096 --clients 4
    --ops 200`) through the port: 7 replicas, quorum 5 (f = 2, the
    reference default's active set), Paillier-2048 (the bench key) and
    RSA-1024. The preload's rows are encrypted once. On
    `crypto-backend = "cuda"` two stacks load them, the legacy one and a
    second with `[search]` on, and the search phase runs on both
    (`search_rest`: parity gates around a write burst, warm query ms, the
    cache-less baseline); then `"cpu"` (the same-host baseline mixed.py
    prints), a fresh stack: the preload, then `run_workload` rounds of the
    clients with one seed, first with mixed.py's MIX, then (on cuda only:
    the cpu baseline's default-mix round was cut for the run's time) with
    configs/default.toml's proportions, on each cuda stack; every client
    must report no failed operation. Counts are zeroed just before and
    read just after each round; on the card the cuda rounds must launch
    mont_mul. After the legacy stack's rounds, the route sweep."""
    import dataclasses

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.models._symmetric import aes_available
    from dds_tpu_torch.models.facade import DEFAULT_SCHEMA, HomoProvider
    from dds_tpu_torch.models.keys import HEKeys
    from dds_tpu_torch.run import launch, run_workload
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    keys = dataclasses.replace(HEKeys.generate(512, sizes["rsa_bits"]),
                               psse=bench_paillier_key(sizes["key_bits"]))
    provider = HomoProvider(keys)
    schema = list(DEFAULT_SCHEMA)
    if not aes_available():  # the reference's rule for AES-less hosts
        schema = ["Plain" if c in ("CHE", "None") else c for c in schema]
    R, Q = sizes["mixed_replicas"], sizes["mixed_quorum"]
    rec = {"replicas": R, "quorum": Q, "preload": sizes["mixed_preload"],
           "clients": sizes["mixed_clients"], "ops_per_client": sizes["mixed_ops"],
           "seed": sizes["mixed_seed"], "schema": schema, "rounds": {}}
    rows = encrypt_rows(provider, schema, 0, sizes["mixed_preload"])

    def config(backend: str, search: bool):
        cfg = DDSConfig()
        cfg.replicas.endpoints = [f"replica-{i}" for i in range(R)]
        cfg.replicas.byz_quorum_size, cfg.replicas.byz_max_faults = Q, (R - 1) // 3
        cfg.proxy.crypto_backend = backend
        cfg.proxy.device = dev.type
        cfg.client.nr_of_operations = sizes["mixed_ops"]
        cfg.client.nr_of_local_clients = sizes["mixed_clients"]
        cfg.client.data_table.fixed_columns_hcrypt = schema
        cfg.search.enabled = search
        return cfg

    async def rounds(dep, labels, stack: str) -> None:
        for label, mix in labels:
            dep.cfg.client.proportions = dict(mix)
            reset_counts()  # this round's run starts here
            tracer.reset(max_events=1 << 21)
            t = time.perf_counter()
            reports = await run_workload(dep, provider, seed=sizes["mixed_seed"])
            wall = time.perf_counter() - t
            counts = read_counts(dev)
            backend = dep.cfg.proxy.crypto_backend
            if any(r.failed for r in reports):
                raise AssertionError(f"{label} round on {stack}: failed operations: "
                                     f"{[vars(r) for r in reports]}")
            if backend == "cuda" and dev.type == "cuda" and counts["mont_mul"] <= 0:
                raise AssertionError(f"the {label} round on {stack} never launched mont_mul")
            ops = sum(r.operations for r in reports)
            rec["rounds"][f"{label}.{stack}"] = {
                "ops": ops, "wall_s": wall, "ops_per_sec": ops / wall,
                "succeeded": sum(r.succeeded for r in reports),
                "not_found": sum(r.not_found for r in reports), "failed": 0,
                "stored": len(dep.server.stored_keys), "preload_s": preload_s,
                "mont_mul_launches": counts["mont_mul"],
                "launches": {k: v for k, v in counts.items() if v},
                "spans": span_stats(("http.", "proxy.fold", "proxy.fetch_stored",
                                     "proxy.search_eval", "kernel.predicate", "abd.read_tags")),
                "predicate_calls": predicate_calls(tracer.events("kernel.predicate.dispatch")),
            }

    labels = (("mixed", MIXED_MIX), ("default", DEFAULT_TOML_MIX))
    for backend in ("cuda", "cpu"):
        dep = await launch(config(backend, False))
        spy = await launch(config(backend, True)) if backend == "cuda" else None
        try:
            port = dep.server.cfg.port
            t = time.perf_counter()
            preloaded = await preload(port, rows)
            preload_s = time.perf_counter() - t
            if spy is not None:
                if await preload(spy.server.cfg.port, rows) != preloaded:
                    raise AssertionError("the stacks' preloads gave different keys")
                rec["search"] = await search_rest(dev, sizes, dep, spy, provider, keys,
                                                  schema)
                preloaded = {k: i for k, i in preloaded.items() if k in dep.server.stored_keys}
            await rounds(dep, labels if backend == "cuda" else labels[:1], backend)
            if spy is not None:
                await rounds(spy, labels, "cuda_search")
                rec["search"]["rounds"] = {
                    label: {"indexed_ops_per_sec": rec["rounds"][f"{label}.cuda_search"][
                                "ops_per_sec"],
                            "legacy_ops_per_sec": rec["rounds"][f"{label}.cuda"]["ops_per_sec"]}
                    for label, _ in labels}
            if backend == "cuda":
                rec["route_sweep"] = await route_sweep(
                    port, sorted(dep.server.stored_keys), keys, schema, preloaded)
        finally:
            if spy is not None:
                await spy.stop()
            await dep.stop()
    rec["cuda_over_cpu"] = {
        "mixed": rec["rounds"]["mixed.cuda"]["ops_per_sec"]
        / rec["rounds"]["mixed.cpu"]["ops_per_sec"]}
    rec["mont_mul_launches"] = sum(rec["rounds"][f"{label}.{stack}"]["mont_mul_launches"]
                                   for label, _ in labels for stack in ("cuda", "cuda_search"))
    emit("mixed", **{k: v for k, v in rec.items() if k != "search"})
    emit("search", what="rest", **rec["search"])
    return rec


def held_ms(fn, reps: int, dev, cycles: int = 100_000_000) -> tuple[float, float]:
    """(device ms, host dispatch ms) per call of `fn`: the stream is held
    (`torch.cuda._sleep(cycles)`, ~50 ms by default) while the host queues
    `reps` calls between two CUDA events, so the events read the device's
    time alone and the host clock around the loop reads the dispatch
    alone, as long as the hold outlasts the dispatch. One warm-up call
    first. On the CPU (rehearsal) both are host clock readings."""
    import torch

    fn()
    sync(dev)
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / reps
        return ms, ms
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    t0.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dispatch = (time.perf_counter() - t) * 1e3 / reps
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps, dispatch


class unsynced:
    """Within the block, `kprof.profiled` does not wait for the device, so
    `held_ms` can queue predicate ops behind a held stream and read their
    device time apart from their dispatch (the ops themselves are
    unchanged)."""

    def __enter__(self):
        from dds_tpu_torch.obs import kprof

        self.kprof, self.wait = kprof, kprof.wait
        kprof.wait = lambda out: None

    def __exit__(self, *exc):
        self.kprof.wait = self.wait


def predicate_bytes(name: str, n: int, width: int = 1) -> float:
    """Bytes a predicate op must move over n rows: its int64 lanes read
    once (two a row, an (n, width) pair and the validity bytes for the
    entry matrix), its result written once (a bool a row; an int64 index
    a row for the sort)."""
    if name == "entry_mask":
        return 17.0 * n * width + n
    if name == "sort_perm":
        return 16.0 * n + 8 * n
    return 16.0 * n + n


def phase_search_plane(dev, sizes) -> dict:
    """The search plane alone, no REST: one `GroupIndex` on the device
    filled with one full resident pool's rows (65,536), packable OPE
    values with ties and the lane edges, DET labels and element words.
    Each `eval_*` must equal the plain Python reference computed from the
    same rows. Reports each pack's build ms, each eval's ms against the
    Python reference's, and each predicate op held on the pack's lanes
    (device ms, dispatch ms), beside its bound (bytes at 3.35 TB/s) and one
    PyTorch call on the folded int64 column (`torch.gt`, `torch.eq`,
    `torch.sort(stable=True)`) where one computes the same selection."""
    import operator

    import torch

    from dds_tpu_torch.ops import predicate as pr
    from dds_tpu_torch.search import GroupIndex

    t_phase = time.perf_counter()
    N, reps = sizes["search_plane_rows"], sizes["search_plane_reps"]
    rng = np.random.default_rng(31)
    pool = rng.integers(0, 1 << 40, size=max(1, N // 16))
    ope = [int(v) for v in rng.choice(pool, size=N)]
    ope[:4] = [0, pr.LANE_MASK, pr.LANE_MASK + 1, pr.PACK_MAX]
    labels = [f"label-{int(x)}" for x in rng.integers(0, max(2, N // 64), size=N)]
    rows = {f"k{i:06d}": [ope[i], labels[i]] + [f"w{int(x)}" for x in
                                                  rng.integers(0, 64, size=int(rng.integers(1, 4)))]
            for i in range(N)}
    keys = sorted(rows)
    idx = GroupIndex(dev)
    t = time.perf_counter()
    for k in keys:
        idx.upsert(k, (1, 0), rows[k])
    rec = {"rows": N, "device": str(idx.device), "fill_ms": (time.perf_counter() - t) * 1e3,
           "build_ms": {}}
    with idx._lock:
        for name, build in (("ope", lambda: idx._ope_pack(0)), ("det", lambda: idx._det_pack(1)),
                            ("entry", idx._entry_pack)):
            t = time.perf_counter()
            pack = build()
            sync(dev)
            rec["build_ms"][name] = (time.perf_counter() - t) * 1e3
    ope_p, det_p, ent_p = idx._packs[("ope", 0)], idx._packs[("det", 1)], idx._packs[("entry",)]
    if ope_p["hi"].device.type != dev.type or ent_p["dhi"].device.type != dev.type:
        raise AssertionError("the packs are not on the plane's device")

    host_ops = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt, "le": operator.le}
    thr = ope[17]  # a stored value: ties at the threshold
    lo_b, hi_b = sorted((ope[5], ope[6]))
    label, words = labels[3], ["w3", labels[9], "nowhere"]

    def order(desc):
        sign = -1 if desc else 1
        return [(sign * rows[keys[i]][0], keys[i])
                for i in sorted(range(N), key=lambda i: rows[keys[i]][0], reverse=desc)]

    def entry(mode):
        agg = all if mode == "all" else any
        return {k for k in keys if agg(any(e == q for e in map(str, rows[k])) for q in words)}

    evals = {f"compare_{op}": (lambda op=op: idx.eval_compare(0, op, thr),
                               lambda op=op: {k for k in keys if host_ops[op](rows[k][0], thr)})
             for op in host_ops}
    evals.update({
        "range": (lambda: idx.eval_range(0, lo_b, hi_b),
                  lambda: {k for k in keys if lo_b <= rows[k][0] <= hi_b}),
        "eq": (lambda: idx.eval_eq(1, label, True),
               lambda: {k for k in keys if rows[k][1] == label}),
        "neq": (lambda: idx.eval_eq(1, label, False),
                lambda: {k for k in keys if rows[k][1] != label}),
        "entry_any": (lambda: idx.eval_entry(words, "any"), lambda: entry("any")),
        "entry_all": (lambda: idx.eval_entry(words[:2], "all"),
                      lambda: {k for k in keys if all(any(e == q for e in map(str, rows[k]))
                                                      for q in words[:2])}),
        "order_asc": (lambda: idx.eval_order(0, False), lambda: order(False)),
        "order_desc": (lambda: idx.eval_order(0, True), lambda: order(True)),
    })
    rec["evals"] = {}
    for name, (dev_fn, host_fn) in evals.items():
        got = dev_fn()  # warm
        t = time.perf_counter()
        got = dev_fn()
        ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = host_fn()
        host_ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise AssertionError(f"search plane: {name} differs from the Python reference")
        rec["evals"][name] = {"ms": ms, "python_ms": host_ms,
                              "selected": len(got)}

    hi, lo, dhi, dlo = ope_p["hi"], ope_p["lo"], det_p["dhi"], det_p["dlo"]
    folded = (hi << pr.LANE_BITS) | lo
    dfold = (dhi << 32) | dlo  # the digest's 64 bits (two's complement)
    qhi, qlo = pr.digest_lanes(label)
    qfold = ((qhi << 32) | qlo) - ((1 << 64) if qhi >> 31 else 0)
    width = ent_p["dhi"].shape[1]
    calls = {
        "compare_mask": (lambda: pr.compare_mask(hi, lo, "gt", thr, device=dev),
                         lambda: torch.gt(folded, thr)),
        "range_mask": (lambda: pr.range_mask(hi, lo, lo_b, hi_b, device=dev), None),
        "eq_mask": (lambda: pr.eq_mask(dhi, dlo, label, device=dev),
                    lambda: torch.eq(dfold, qfold)),
        "entry_mask": (lambda: pr.entry_mask(ent_p["dhi"], ent_p["dlo"], ent_p["valid"],
                                             words, "any", device=dev), None),
        "sort_perm": (lambda: pr.sort_perm(hi, lo, True, device=dev),
                      lambda: torch.sort(folded, stable=True)),
    }
    if not torch.equal(calls["compare_mask"][0](), calls["compare_mask"][1]()) or \
            not torch.equal(calls["eq_mask"][0](), calls["eq_mask"][1]()):
        raise AssertionError("a library call does not compute its op's selection")
    rec["ops"] = {}
    for name, (fn, lib) in calls.items():
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        wall = (time.perf_counter() - t) * 1e3 / reps  # synced, as the plane calls it
        with unsynced():
            device_ms, dispatch_ms = held_ms(fn, reps, dev)
        lib_ms = held_ms(lib, reps, dev)[0] if lib is not None else None
        nbytes = predicate_bytes(name, N, width)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rec["ops"][name] = {"n": N, "ms": device_ms, "dispatch_ms": dispatch_ms,
                            # the hold (~50 ms) outlasted the queueing, so
                            # the events read the device alone
                            "held_clean": dev.type != "cuda" or dispatch_ms * reps < 45.0,
                            "wall_ms": wall, "bound_ms": bound, "bound_by": "bytes",
                            "bytes": nbytes, "rows_per_s": N / (wall / 1e3),
                            "library_ms": lib_ms, "share": bound / device_ms}
    rec["seconds"] = time.perf_counter() - t_phase
    emit("search", what="plane", **rec)
    return rec


def seeded_ints(ctx, count: int, seed: int) -> list[int]:
    """`count` distinct seeded residues below n as Python ints."""
    from dds_tpu_torch.ops import bignum as bn

    out = bn.batch_to_ints(residues(ctx, count, seed))
    if len(set(out)) != count:
        raise AssertionError("seeded residues repeat")
    return out


def split(ops: list[int], S: int) -> list[tuple[str, list[int]]]:
    """`ops` split evenly into S groups s0..s{S-1} (the plane's parts)."""
    k = len(ops) // S
    return [(f"s{g}", ops[g * k: (g + 1) * k]) for g in range(S)]


async def wait_ingested(server) -> None:
    """Until the proxy's write-ingest drain has run dry (its task done and
    nothing queued)."""
    while True:
        task = server._ingest_task
        if task is not None and not task.done():
            await task
        elif server._resident.pending_ingest():
            await asyncio.sleep(0.01)
        else:
            return


async def phase_resident(dev, sizes) -> dict:
    """The resident plane (`benchmarks/resident_fold.py` at the
    deployment's size): configs/sharded.toml's `[resident]` (4 groups,
    initial-rows 256, max-rows 65,536) at Paillier-2048's n^2 (L = 256),
    seeded residues. Plane level, for S in {1, 4} groups and K operands
    split evenly over them, in modes 0, 1 and 2: *cold*, the per-group
    marshaling baseline (S `ints_to_batch`, S `reduce_mul`, then
    `combine_partials`), and *warm*, `fold_groups` after ingest, each equal
    to the Python-int product; the warm folds' launches (counts zeroed
    just before and read just after each mode, its own fold kernels only;
    a fused fold launches one `mont_mul` a level in mode 0: 14 at S = 4,
    K = 8,192); the fused tree's device ms (stream held) against its host
    dispatch ms. Then all 4 pools filled to max-rows (256 MiB at L = 256)
    and one fold past the cap without Stratum: one reset, still exact.
    REST level: a fresh 4-replica stack (f = 1, min_device_batch 0) with
    `[resident]` on and min-fold 0, K_path PutSet rows, SumAll in modes 0,
    1 and 2 through `proxy.resident_fold`, each decrypting to the total and
    equal to the Python-int fold; then `resident_new` more PutSets once the
    pool exists, the write-ingest drain run dry, and the next SumAll
    ingesting 0 rows on the fold path and equal to the fold over all
    rows."""
    import os

    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.models.backend import CudaBackend
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.parallel.mesh import combine_partials
    from dds_tpu_torch.resident.plane import fused_fold, fused_fold_launches

    key = bench_paillier_key(sizes["key_bits"])
    n2 = key.nsquare
    ctx = ModCtx.make(n2)
    be = CudaBackend(device=dev, min_device_batch=0)
    G, initial, cap = sizes["resident_groups"], sizes["resident_initial"], sizes["resident_max"]
    reps = sizes["resident_reps"]
    saved = os.environ.get("DDS_KARATSUBA")
    rec = {"L": ctx.L, "groups": G, "initial_rows": initial, "max_rows": cap,
           "cells": {}, "modes": {m: {"launches": dict.fromkeys(FOLD_KERNELS, 0)}
                                  for m in ("0", "1", "2")}}
    try:
        for K in sizes["resident_K"]:
            ops = seeded_ints(ctx, K, 70 + K)
            want = host_product(ops, n2)
            for S in sizes["resident_S"]:
                parts = split(ops, S)
                plane = be.resident_plane(initial, cap)

                def cold() -> int:
                    partials = []
                    for _, g in parts:
                        rows = bn.to_device(bn.ints_to_batch(g, ctx.L), dev)
                        partials.append(bn.limbs_to_int(
                            bn.to_host(be.reduce_mul_device(ctx, rows))[0]))
                    return combine_partials(partials, n2)

                cell = {"S": S, "K": K, "modes": {}}
                for mode in ("0", "1", "2"):
                    os.environ["DDS_KARATSUBA"] = mode
                    cold_ms, warm_ms = [], []
                    for _ in range(reps):
                        t = time.perf_counter()
                        if cold() != want:
                            raise AssertionError(f"cold S={S} K={K} mode {mode} != Python")
                        cold_ms.append((time.perf_counter() - t) * 1e3)
                    if plane.fold_groups(parts, n2) != want:  # ingest on the first mode
                        raise AssertionError(f"warm S={S} K={K} mode {mode} != Python")
                    reset_counts()  # this mode's warm folds start here
                    for _ in range(reps):
                        t = time.perf_counter()
                        if plane.fold_groups(parts, n2) != want:
                            raise AssertionError(f"warm S={S} K={K} mode {mode} != Python")
                        warm_ms.append((time.perf_counter() - t) * 1e3)
                    counts = check_mode_launches(dev, read_counts(dev), mode,
                                                 f"resident S={S} K={K}")
                    for k, v in counts.items():
                        rec["modes"][mode]["launches"][k] += v
                    slabs = [plane.pool(g, n2).rows_for(o) for g, o in parts]
                    flag = {"0": False, "1": "k1", "2": "fused"}[mode]
                    dev_ms, dispatch_ms = held_ms(lambda: fused_fold(ctx, slabs, flag), 3, dev)
                    cell["modes"][mode] = {
                        "cold_ms": min(cold_ms), "warm_ms": min(warm_ms),
                        "cold_over_warm": min(cold_ms) / min(warm_ms),
                        "fused_device_ms": dev_ms, "fused_dispatch_ms": dispatch_ms,
                        "launches_per_fold": {k: v // reps for k, v in counts.items() if v},
                    }
                predicted = fused_fold_launches([len(g) for _, g in parts])
                cell["fused_launches_predicted"] = predicted
                if dev.type == "cuda" and \
                        cell["modes"]["0"]["launches_per_fold"]["mont_mul"] != predicted:
                    raise AssertionError(f"S={S} K={K}: {cell['modes']['0']} launches, "
                                         f"predicted {predicted} a fold")
                cell["per_group_launches"] = S * mont_cuda.fold_launches(K // S)
                rec["cells"][f"S{S}_K{K}"] = cell
                emit("resident", what="cell", **cell)
                del plane
        os.environ["DDS_KARATSUBA"] = "0"
        # every pool at max-rows, then one fold past the cap without Stratum
        full = be.resident_plane(initial, cap)
        for g in range(G):
            full.pool(f"s{g}", n2).ingest(seeded_ints(ctx, cap, 900 + g))
        pools = [full.pool(f"s{g}", n2) for g in range(G)]
        full_bytes = sum(p.nbytes() for p in pools)
        allocated = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        fresh = seeded_ints(ctx, sizes["K_path"], 999)
        past = full.fold_groups([("s0", fresh)], n2)
        if past != host_product(fresh, n2):
            raise AssertionError("the fold past the cap is not exact")
        if [p.resets for p in pools] != [1] + [0] * (G - 1):
            raise AssertionError(f"resets past the cap: {[p.resets for p in pools]}")
        rec["full"] = {"rows": [p.resident for p in pools], "bytes": full_bytes,
                       "allocated_bytes": allocated, "resets_after_past_cap":
                       [p.resets for p in pools], "past_cap_K": len(fresh)}
        del full, pools
        rec["rest"] = await resident_rest(dev, sizes, key)
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
    emit("resident", what="summary", **{k: v for k, v in rec.items() if k != "cells"})
    return rec


async def resident_rest(dev, sizes, key) -> dict:
    """The REST half of the resident phase (its docstring)."""
    import os

    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    pk = key.public
    K, new = sizes["K_path"], sizes["resident_new"]
    rows, _ = paillier_rows(pk, K + new, 14)
    total = K * (K + 1) // 2
    cts = [r[PSSE_POS] for r in rows]
    want = host_product(cts[:K], pk.nsquare)
    cfg = DDSConfig()
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    cfg.resident.enabled = True
    cfg.resident.initial_rows = sizes["resident_initial"]
    cfg.resident.max_rows = sizes["resident_max"]
    cfg.resident.min_fold = 0
    rec = {"K": K, "modes": {}}
    dep = await launch(cfg)
    try:
        server = dep.server
        port = server.cfg.port
        rec["put_s"] = await put_rows(port, rows[:K])
        await wait_ingested(server)  # no pool yet: every write is a no_pool drop
        sumall = sumall_fn(port, pk.nsquare)
        t = time.perf_counter()
        if await sumall() != want:
            raise AssertionError("resident SumAll != Python-int fold")
        rec["first_sumall_ms"] = (time.perf_counter() - t) * 1e3
        pool = server._resident.pool("", pk.nsquare)
        for mode in ("0", "1", "2"):
            os.environ["DDS_KARATSUBA"] = mode
            reset_counts()  # this mode's SumAlls start here
            tracer.reset()
            seq = []
            for _ in range(sizes["requests"]):
                t = time.perf_counter()
                result = await sumall()
                seq.append((time.perf_counter() - t) * 1e3)
                if result != want or key.decrypt(result) != total:
                    raise AssertionError(f"resident SumAll wrong (DDS_KARATSUBA={mode})")
            counts = check_mode_launches(dev, read_counts(dev), mode, "resident SumAll")
            spans = tracer.summary()
            if spans.get("proxy.resident_fold", {}).get("count") != sizes["requests"] \
                    or "proxy.fold" in spans:
                raise AssertionError(f"SumAll did not go through the plane: {sorted(spans)}")
            rec["modes"][mode] = {
                "sumall_ms_min": min(seq), "sumall_ms_median": statistics.median(seq),
                "launches": counts,
                "phase_mean_ms": {name: s["mean_ms"] for name, s in spans.items()
                                  if name in ("http.GET.SumAll", "proxy.fetch_stored",
                                              "proxy.resident_fold",
                                              "kernel.resident_fold.dispatch",
                                              "kernel.resident_fold.execute")},
            }
        os.environ["DDS_KARATSUBA"] = "0"
        rec["matvec"] = await resident_matvec(dev, sizes, server, key, rows[:K])
        # writes after the pool exists: ingested off the request path
        t = time.perf_counter()
        await put_rows(port, rows[K:])
        await wait_ingested(server)
        rec["new_rows"], rec["ingest_s"] = new, time.perf_counter() - t
        ingested = pool._served[1]
        resident_before = pool.resident
        t = time.perf_counter()
        result = await sumall()
        rec["post_write_sumall_ms"] = (time.perf_counter() - t) * 1e3
        rec["post_write_fold_ingested"] = pool._served[1] - ingested
        if rec["post_write_fold_ingested"] != 0 or pool.resident != resident_before:
            raise AssertionError(f"the first SumAll after the writes ingested "
                                 f"{rec['post_write_fold_ingested']} rows on the fold path")
        if result != host_product(cts, pk.nsquare) or \
                key.decrypt(result) != (K + new) * (K + new + 1) // 2:
            raise AssertionError("post-write SumAll != the fold over every row")
        rec["pool"] = pool.stats()
        rec["dropped_pending"] = server._resident.stats()["dropped_pending"]
    finally:
        await dep.stop()
    return rec


async def resident_matvec(dev, sizes, server, key, rows) -> dict:
    """One MatVec (`analytics_R` rows of 16-bit weights, mode 0) on the
    `[resident]` stack after its SumAlls: its operands must gather through
    `ResidentPlane.rows_for` once, from the pool the SumAlls filled; the
    answer must decrypt to W @ x and equal the same request's weighted
    fold on the marshaling path (`CudaBackend.matvec` without rows, what a
    stack without `[resident]` runs on the same column); its `mont_mul`
    launches must be the ladder's."""
    from dds_tpu_torch.models.backend import CudaBackend
    from dds_tpu_torch.ops import foldmany
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.utils import sigs

    pk = key.public
    n2 = pk.nsquare
    by_key = {sigs.key_from_set(r): (i + 1, r[PSSE_POS]) for i, r in enumerate(rows)}
    keys = sorted(by_key)
    xs = [by_key[k][0] for k in keys]
    cs = [by_key[k][1] for k in keys]
    W = analytics_requests(keys, np.random.default_rng(22), sizes["analytics_R"])["matvec"][2]
    plane = server._resident
    gathers = []
    real = plane.rows_for

    def counting(*args, **kw):
        got = real(*args, **kw)
        gathers.append(None if got is None else tuple(got.shape))
        return got

    plane.rows_for = counting
    reset_counts()  # the MatVec's launches start here
    try:
        answer, host_ms = await analytics_call(server.cfg.port, "MatVec", n2, {"weights": W})
    finally:
        del plane.rows_for
    counts = check_mode_launches(dev, read_counts(dev), "0", "resident MatVec")
    got = analytics_results(answer)
    if [key.decrypt_signed(c) for c in got] != [sum(w * x for w, x in zip(r, xs)) for r in W]:
        raise AssertionError("the resident MatVec does not decrypt to W @ x")
    if gathers != [(len(keys), ModCtx.make(n2).L)]:
        raise AssertionError(f"the resident MatVec gathered {gathers}, not once through rows_for")
    if got != CudaBackend(device=dev, min_device_batch=0).matvec(cs, W, n2):
        raise AssertionError("the resident MatVec != the marshaling path's weighted fold")
    expected = foldmany.fold_weighted_launches(len(keys), 4)
    if dev.type == "cuda" and counts["mont_mul"] != expected:
        raise AssertionError(f"resident MatVec launched {counts}, expected {expected} mont_mul")
    return {"R": len(W), "K": len(keys), "host_ms": host_ms, "gathers": len(gathers),
            "launches": counts, "equals_marshaling_path": True, "decrypt_ok": True}


def zipf_draws(rng, head: list[int], k: int, theta: float) -> list[int]:
    """`k` draws from a Zipf(theta) rank distribution over `head` (rank 0
    the most popular) — `benchmarks/tiered_fold.py::_zipf_hot_subset`'s
    model, drawn with numpy."""
    w = 1.0 / np.arange(1, len(head) + 1) ** theta
    return [head[i] for i in rng.choice(len(head), size=k, p=w / w.sum())]


async def phase_tiered(dev, sizes) -> dict:
    """Stratum (`benchmarks/tiered_fold.py`) with configs/stratum.toml's
    `[resident]` and `[storage]`: 2 groups, max-rows 4,096, chunk-rows
    256, promote-score 2.0, max-promote 256, at Paillier-2048's n^2; a
    population of pop-factor (10) x max-rows seeded residues per group,
    folded once through Stratum (the first max-rows of each group admit
    hot, the rest stream and demote to warm and cold); then the timed
    folds draw K operands, half a group, from a Zipf(theta) head of
    `tier_head` rows per group: the population's last rows, which that
    fold left in the warm and cold tiers. One cut: warm-bytes follows
    tiered_fold's rule (max-rows x pop-factor x 16 bytes), since
    stratum.toml's 128 MiB would hold the whole population warm and never
    run the cold leg. The segment log lives in a temporary directory.
    Gates: the population fold and every timed fold equal the Python-int
    product; no reset; the cold tier holds rows and cold reads happen;
    promotion moves the head's most drawn rows back to hot. Timed: an
    all-resident twin plane (the ceiling) against Stratum; launches of the
    Stratum run in mode 0 and of one fold in modes 1 and 2. Then a REST
    SumAll through a fresh stack with `[resident]` max-rows 4,096 and
    `[storage]` (the same cut), K_path PutSet rows: it decrypts to the
    total, with no reset."""
    import os
    import tempfile

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.models.backend import CudaBackend
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.storage import HOT, Stratum
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    n2 = key.nsquare
    ctx = ModCtx.make(n2)
    be = CudaBackend(device=dev, min_device_batch=0)
    S, cap, factor = sizes["tier_groups"], sizes["tier_max"], sizes["tier_pop_factor"]
    head_n, K, reps = sizes["tier_head"], sizes["tier_K"], sizes["tier_reps"]
    warm_bytes = cap * factor * 16
    pop = seeded_ints(ctx, S * cap * factor, 41)
    parts = split(pop, S)
    rng = np.random.default_rng(43)
    heads = {g: ops[::-1][:head_n] for g, ops in parts}  # rank 0 = the last row
    draws = [(g, zipf_draws(rng, heads[g], K // S, sizes["tier_theta"])) for g, _ in parts]
    want_pop = host_product(pop, n2)
    want = host_product([c for _, d in draws for c in d], n2)
    saved = os.environ.get("DDS_KARATSUBA")
    os.environ["DDS_KARATSUBA"] = "0"
    rec = {"groups": S, "max_rows": cap, "population": len(pop), "pop_factor": factor,
           "head": head_n, "K": K, "theta": sizes["tier_theta"],
           "cut": {"warm_bytes": warm_bytes, "stratum_toml_warm_bytes": 134217728,
                   "rule": "max_rows x pop_factor x 16 (benchmarks/tiered_fold.py)"},
           "modes": {}}
    try:
        twin = be.resident_plane(cap, 1 << max(17, (len(pop) // S).bit_length() + 1))
        if twin.fold_groups(parts, n2) != want_pop or twin.fold_groups(draws, n2) != want:
            raise AssertionError("the all-resident twin != Python")
        ceiling = []
        for _ in range(reps):
            t = time.perf_counter()
            if twin.fold_groups(draws, n2) != want:
                raise AssertionError("ceiling fold != Python")
            ceiling.append((time.perf_counter() - t) * 1e3)
        del twin
        with tempfile.TemporaryDirectory() as tier_dir:
            plane = be.resident_plane(sizes["resident_initial"], cap)
            stratum = Stratum(plane, tier_dir, warm_bytes=warm_bytes,
                              chunk_rows=sizes["tier_chunk"],
                              promote_score=sizes["tier_promote"],
                              max_promote=sizes["tier_max_promote"])
            reset_counts()  # the tiered run starts here
            tracer.reset()
            t = time.perf_counter()
            if stratum.fold_groups(parts, n2) != want_pop:
                raise AssertionError("the tiered population fold != Python")
            rec["population_fold_s"] = time.perf_counter() - t
            rec["after_population"] = stratum.stats()
            warmup = []
            for _ in range(sizes["tier_warmup"]):
                t = time.perf_counter()
                if stratum.fold_groups(draws, n2) != want:
                    raise AssertionError("tiered warm-up fold != Python")
                warmup.append((time.perf_counter() - t) * 1e3)
            tiered = []
            for _ in range(reps):
                t = time.perf_counter()
                if stratum.fold_groups(draws, n2) != want:
                    raise AssertionError("tiered fold != Python")
                tiered.append((time.perf_counter() - t) * 1e3)
            counts = check_mode_launches(dev, read_counts(dev), "0", "tiered")
            spans = span_stats(("tier.", "kernel.resident_fold"))
            stats = stratum.stats()
            pools = [plane.pool(g, n2) for g, _ in parts]
            # the head's most drawn rows, back on the device
            top = {g: [c for c, _ in collections.Counter(d).most_common(sizes["tier_top"])]
                   for g, d in draws}
            hot_top = {g: sum(stratum.dir.tier_of((g, "", n2), c) == HOT
                              and c in plane.pool(g, n2)._index for c in cs)
                       for g, cs in top.items()}
            if any(p.resets for p in pools):
                raise AssertionError(f"a pool reset under Stratum: {[p.resets for p in pools]}")
            if stats["tiers"]["cold"]["rows"] <= 0 or stats["cold_reads"] <= 0:
                raise AssertionError(f"the cold tier never served: {stats}")
            if stats["promotions"] <= 0 or any(v != len(top[g]) for g, v in hot_top.items()):
                raise AssertionError(f"promotion did not bring the head back: {hot_top}, "
                                     f"{stats['promotions']} promotions")
            rec["modes"]["0"] = {"launches": counts}
            for mode in ("1", "2"):
                os.environ["DDS_KARATSUBA"] = mode
                reset_counts()  # this mode's tiered fold starts here
                if stratum.fold_groups(draws, n2) != want:
                    raise AssertionError(f"tiered fold != Python (DDS_KARATSUBA={mode})")
                rec["modes"][mode] = {"launches": check_mode_launches(
                    dev, read_counts(dev), mode, "tiered")}
            os.environ["DDS_KARATSUBA"] = "0"
            rec.update({
                "ceiling_ms": min(ceiling), "tiered_ms": min(tiered),
                "ceiling_over_tiered": min(ceiling) / min(tiered),
                "tiered_ms_all": tiered, "warmup_ms": warmup,
                "resets": [p.resets for p in pools], "hot_rows": [p.resident for p in pools],
                "head_top_hot": hot_top, "spans": spans,
                "tiers": stats["tiers"], "hits": stats["hits"],
                "evictions": stats["evictions"], "cold_reads": stats["cold_reads"],
                "promotions": stats["promotions"], "demotions": stats["demotions"],
                "directory": stats["directory"], "pressure": stats["pressure"],
            })
        rec["rest"] = await tiered_rest(dev, sizes, key, warm_bytes)
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
    emit("tiered", **rec)
    return rec


async def tiered_rest(dev, sizes, key, warm_bytes: int) -> dict:
    """The REST half of the tiered phase (its docstring)."""
    import tempfile

    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    pk = key.public
    K = sizes["K_path"]
    rows, total = paillier_rows(pk, K, 15)
    want = host_product([r[PSSE_POS] for r in rows], pk.nsquare)
    with tempfile.TemporaryDirectory() as tier_dir:
        cfg = DDSConfig()
        cfg.proxy.device = dev.type
        cfg.proxy.min_device_batch = 0
        cfg.resident.enabled = True
        cfg.resident.initial_rows = sizes["resident_initial"]
        cfg.resident.max_rows = sizes["tier_max"]
        cfg.storage.enabled = True
        cfg.storage.dir = tier_dir
        cfg.storage.warm_bytes = warm_bytes
        cfg.storage.chunk_rows = sizes["tier_chunk"]
        dep = await launch(cfg)
        try:
            server = dep.server
            port = server.cfg.port
            put_s = await put_rows(port, rows)
            sumall = sumall_fn(port, pk.nsquare)
            reset_counts()  # the REST tiered SumAlls start here
            tracer.reset()
            ms = []
            for _ in range(2):  # the first ingests and tiers, the second reads the tiers
                t = time.perf_counter()
                result = await sumall()
                ms.append((time.perf_counter() - t) * 1e3)
                if result != want or key.decrypt(result) != total:
                    raise AssertionError("tiered REST SumAll wrong")
            counts = check_mode_launches(dev, read_counts(dev), "0", "tiered REST")
            resets = server._resident.stats()["resets"]
            if resets:
                raise AssertionError(f"the tiered REST stack reset a pool {resets} times")
            stats = server._stratum.stats()
            spans = tracer.summary()
        finally:
            await dep.stop()
    return {"K": K, "put_s": put_s, "sumall_ms": ms, "resets": resets,
            "launches": counts, "tiers": stats["tiers"], "hits": stats["hits"],
            "resident_fold_count": spans.get("proxy.resident_fold", {}).get("count")}


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

    from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models._symmetric import aes_available
    from dds_tpu_torch.models.facade import DEFAULT_SCHEMA
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
        reset_counts()  # the client path's run starts here
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
        counts = read_counts(dev)
        exp_count, mul_count = counts["mont_exp"], counts["mont_mul"]

        sem = asyncio.Semaphore(64)

        async def get(key):
            async with sem:
                st, b = await http_request("127.0.0.1", port, "GET", f"/GetSet/{key}")
            if st != 200:
                raise AssertionError(f"GetSet {key} failed: {st}")
            return json.loads(b)["contents"]

        # each client ran its PutSets in order: its keys follow its digest
        keys = [k for c in clients for k in c.stored_keys]
        contents = await asyncio.gather(*(get(k) for k in keys))
        stored = [int(row[PSSE_POS]) for row in contents]
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
    # for the decrypt phase: the stored rows as GetSet read them back, their
    # plaintext rows, the schema and the client's keys
    return {**rec, "rows": contents, "plain_rows": [i.set for d in digests for i in d.payload],
            "keys_json": provider.keys.to_json()}


def rowmod_work(L: int, cols: int, products: int, E: int = 0) -> tuple[float, float]:
    """(integer multiply-adds, bytes) of `cols` columns of `products`
    Montgomery products each at L limbs (2W^2 + W word products of 2
    IMADs); bytes: the limbs-major operands (2 (L, cols) int32 for a
    product, the base and R mod N for a ladder with its (E, cols) digits)
    and the column's modulus words and n0inv read once, the (L, cols)
    result written once."""
    W = (L + 1) // 2
    imads = cols * products * (2 * W * W + W) * 2
    nbytes = cols * (3 * L + E + W + 1) * 4
    return imads, nbytes


def decrypt_cts(key, B: int, seed: int) -> tuple[list[int], list[int]]:
    """(plaintexts, ciphertexts): B seeded 48-bit plaintexts under a small
    rotating obfuscator pool, as benchmarks/decrypt_throughput.py makes
    them (a decrypt measurement; the pool keeps set-up cheap)."""
    pk = key.public
    rng = np.random.default_rng(seed)
    ms = [int(x) for x in rng.integers(0, 1 << 48, size=B)]
    blinds = [pk.blind(int.from_bytes(rng.bytes(pk.n.bit_length() // 8 - 1), "little"))
              for _ in range(16)]
    return ms, [pk.encrypt(m, rn=blinds[i % 16]) for i, m in enumerate(ms)]


def best_s(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def phase_decrypt(dev, sizes, client, card) -> dict:
    """`benchmarks/decrypt_throughput.py`'s shape on the port: per-op
    `decrypt`, `decrypt_batch` on the host plan and the Sanctum device
    plan at each key size and B ciphertexts, every path decrypt-verified
    before any timing; the device plan at the main key size and larger B
    (full chunks) with its spans, the host's marshal and recombination,
    and its launches; each kernel held at one chunk's columns beside its
    bound, its plain version once, and the shared-modulus exp kernel
    twice as a yardstick; then the path through the entry points
    (`run.load_provider` with `[crypto] secret-device`, `decrypt_rows`
    over the client phase's stored rows) and the hygiene checks."""
    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops import montgomery, mont_cuda
    from dds_tpu_torch.ops.bignum import batch_to_ints, to_device
    from dds_tpu_torch.run import load_provider
    from dds_tpu_torch.sanctum import SecretBackend, is_secret_backend, plan_for
    from dds_tpu_torch.sanctum.device import _crt_columns
    from dds_tpu_torch.sanctum.plane import _crt_recombine
    from dds_tpu_torch.utils.config import DDSConfig
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    handle = SecretBackend(device=dev)
    B, reps = sizes["decrypt_B"], sizes["decrypt_reps"]
    keys, sizes_rec = [], {}
    for bits in sizes["decrypt_bits"]:
        key = bench_paillier_key(bits)
        keys.append(key)
        ms, cts = decrypt_cts(key, B, 17 + bits)
        host_slice = cts[: max(8, B // 32)]
        if [key.decrypt(c) for c in host_slice] != ms[: len(host_slice)]:
            raise AssertionError(f"per-op decrypt mismatch at {bits} bits")
        if key.decrypt_batch(cts) != ms:
            raise AssertionError(f"host-plan decrypt mismatch at {bits} bits")
        if key.decrypt_batch(cts, backend=handle, min_batch=1) != ms:
            raise AssertionError(f"device-plan decrypt mismatch at {bits} bits")
        plan = plan_for(key, handle)
        per_op = len(host_slice) / best_s(lambda: [key.decrypt(c) for c in host_slice], 1)
        host = B / best_s(lambda: key.decrypt_batch(cts), 1)
        device = B / best_s(lambda: plan.decrypt_batch(cts), reps)
        sizes_rec[bits] = {"B": B, "per_op_ops": per_op, "batched_host_ops": host,
                           "sanctum_device_ops": device, "sanctum_speedup": device / per_op,
                           "verified": True}
    emit("decrypt", what="sizes", sizes=sizes_rec)

    # the main key size's device plan at full chunks
    key = bench_paillier_key(sizes["key_bits"])
    plan = plan_for(key, handle)
    big = {}
    Bmax = max(sizes["decrypt_big"])
    ms, cts = decrypt_cts(key, Bmax, 23)
    for Bb in sizes["decrypt_big"]:
        chunks = -(-Bb // plan.chunk)
        reset_counts()
        if plan.decrypt_batch(cts[:Bb]) != ms[:Bb]:
            raise AssertionError(f"device-plan decrypt mismatch at B={Bb}")
        counts = read_counts(dev)
        want = {"mont_mul_rowmod": 2 * chunks, "mont_exp_rowmod": chunks}
        if dev.type == "cuda" and {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"B={Bb}: launches {counts}, want {want}")
        tracer.reset()
        wall = best_s(lambda: plan.decrypt_batch(cts[:Bb]), reps)
        spans = span_stats(("kernel.sanctum_crt",))
        part = cts[: min(Bb, plan.chunk)]
        Bp = 1 << max(0, (len(part) - 1).bit_length())
        marshal = best_s(lambda: plan._marshal(part, Bp), reps)
        legs = plan._legs(plan._marshal(part, Bp), len(part))
        to_ints = best_s(lambda: (batch_to_ints(legs[: len(part)]),
                                  batch_to_ints(legs[Bp: Bp + len(part)])), reps)
        xps, xqs = batch_to_ints(legs[: len(part)]), batch_to_ints(legs[Bp: Bp + len(part)])
        recombine = best_s(lambda: _crt_recombine(xps, xqs, plan.p, plan.q, plan.n, plan.hp,
                                                  plan.hq, plan.qinv), reps)
        big[Bb] = {"chunks": chunks, "decrypts_per_s": Bb / wall, "wall_ms": wall * 1e3,
                   "launches": want, "spans": spans,
                   "per_chunk_host_ms": {"marshal": marshal * 1e3, "to_ints": to_ints * 1e3,
                                         "recombine": recombine * 1e3}}

    # each kernel held at one chunk's columns (the plan's own inputs)
    part = cts[: plan.chunk]
    Bp = 1 << max(0, (len(part) - 1).bit_length())
    consts = [torch.from_numpy(a).to(dev)
              for a in (plan._N, plan._n0, plan._R2, plan._one, plan._digits)]
    x = to_device(plan._marshal(part, Bp), dev).T.contiguous()
    Nr, n0r, R2r, oner, digr = _crt_columns(Bp, *consts)
    L, cols, E = x.shape[0], x.shape[1], digr.shape[0]
    mul_ms, _ = held_ms(lambda: mont_cuda.mul_rowmod(x, R2r, Nr, n0r), sizes["reps_path"], dev)
    xm = mont_cuda.mul_rowmod(x, R2r, Nr, n0r)
    exp_ms, got = time_ms(lambda: mont_cuda.exp_rowmod(xm, digr, oner, Nr, n0r),
                          sizes["reps_exp"], 1, dev)
    mul_plain_ms, want = time_ms(lambda: mont_cuda.mul_rowmod_plain(x, R2r, Nr, n0r), 1, 0, dev)
    err_mul = max_abs_diff(xm, want)
    k = sizes["decrypt_plain_cols"]  # the plain ladder on a slice: it is slow
    sl = [c for half in (0, cols // 2) for c in range(half, half + k // 2)]
    idx = torch.tensor(sl, device=dev)
    exp_plain_ms, want = time_ms(
        lambda: mont_cuda.exp_rowmod_plain(xm[:, idx], digr[:, idx], oner[:, idx], Nr[idx],
                                           n0r[idx]), 1, 0, dev)
    err_exp = max_abs_diff(got[:, idx], want)
    if err_mul or err_exp:
        raise AssertionError(f"rowmod kernels != plain at the decrypt shape: {err_mul}, {err_exp}")
    mul_bound = bound_ms(*rowmod_work(L, cols, 1), card["sms"], card["clock_mhz"])
    exp_bound = bound_ms(*rowmod_work(L, cols, 5 * E + 14, E), card["sms"], card["clock_mhz"])
    # yardstick: the same ladder as one shared-modulus launch a leg (B3,
    # mont_exp.cu) over two test moduli of p^2's width (key_bits), not a
    # key's, each with one chunk's ciphertexts and a key_bits/2-bit exponent
    yard = []
    rng = np.random.default_rng(24)
    Ly, By = sizes["key_bits"] // 16, sizes["decrypt_big"][0]
    for i in range(2):
        ctx = montgomery.ModCtx.make(int.from_bytes(rng.bytes(2 * Ly), "little")
                                     | 1 | (1 << (16 * Ly - 1)), Ly)
        yard.append((ctx, to_device(residues(ctx, By, 25 + i), dev).T.contiguous()))
    ydig = torch.from_numpy(montgomery._exp_to_digits(
        int.from_bytes(rng.bytes(sizes["key_bits"] // 16), "little")
        | 1 << (sizes["key_bits"] // 2 - 1)).astype(np.int32)).to(dev)
    yard_ms, _ = time_ms(lambda: [mont_cuda.exp(c, xb, ydig) for c, xb in yard],
                         sizes["reps_exp"], 1, dev)
    kern = {"L": L, "columns": cols, "E": E, "products_per_column": 5 * E + 14,
            "mont_mul_rowmod": {"ms": mul_ms, "plain_ms": mul_plain_ms, "bound_ms": mul_bound[0],
                                "bound_by": mul_bound[1], "max_abs_err": err_mul},
            "mont_exp_rowmod": {"ms": exp_ms, "plain_ms": exp_plain_ms, "plain_columns": k,
                                "bound_ms": exp_bound[0], "bound_by": exp_bound[1],
                                "share": exp_bound[0] / exp_ms, "max_abs_err": err_exp},
            "yardstick_two_mont_exp_ms": yard_ms,
            "yardstick": {"L": Ly, "B_each": By, "E": len(ydig)}}
    emit("decrypt", what="device_plan", big=big, kernels=kern)

    # the path through the entry points: load_provider with the opt-in and
    # the client phase's keys, decrypt_rows over the rows it stored
    cfg = DDSConfig()
    cfg.crypto.secret_device = True
    cfg.client.he_keys_inline = client["keys_json"]
    cfg.client.device = dev.type
    provider = load_provider(cfg)
    if not (is_secret_backend(provider.secret_backend)
            and provider.secret_backend.device.type == dev.type):
        raise AssertionError("load_provider with secret-device gave no device Sanctum handle")
    rows, plain = client["rows"], client["plain_rows"]
    reset_counts()
    t = time.perf_counter()
    dec = provider.decrypt_rows(rows, 8, client["schema"])
    rows_s = time.perf_counter() - t
    counts = read_counts(dev)
    chunks = -(-len(rows) // provider.secret_backend.chunk)
    want = {"mont_mul_rowmod": 2 * chunks, "mont_exp_rowmod": chunks}
    if dev.type == "cuda" and {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"decrypt_rows: launches {counts}, want {want}")
    if [r[PSSE_POS] for r in dec] != [r[PSSE_POS] for r in plain]:
        raise AssertionError("decrypt_rows: a PSSE value != its plaintext")
    k = provider.keys.psse
    sample = [int(r[PSSE_POS]) for r in rows[:64]]
    if k.decrypt_batch(sample) != [r[PSSE_POS] for r in dec[:64]]:
        raise AssertionError("decrypt_rows sample != the host plan")
    keys.append(k)

    # hygiene: no key's p or q (or their squares) in ModCtx.make's cache;
    # one mont_rowmod build for every key; scrub() closes the plans
    cached = set(montgomery.cached_moduli())
    leaked = [i for i, kk in enumerate(keys + [key])
              if cached & {kk.p, kk.q, kk.p * kk.p, kk.q * kk.q}]
    if leaked:
        raise AssertionError(f"secret-derived moduli in ModCtx.make's cache (keys {leaked})")
    libs = sorted(p.name for p in mont_cuda.BUILD_DIR.glob("libmont_rowmod-*.so"))
    if dev.type == "cuda" and libs != [mont_cuda.ROWMOD.library_path().name]:
        raise AssertionError(f"mont_rowmod builds: {libs}")
    plans = [plan_for(kk, handle) for kk in keys + [key]]
    for kk in keys + [key]:
        kk.scrub()
    if not all(p.closed and not p._N.any() for p in plans):
        raise AssertionError("scrub() left a device plan open")
    rec = {"rows": {"count": len(rows), "seconds": rows_s, "launches": want,
                    "psse_exact": True, "sample_equals_host": 64},
           "hygiene": {"keys": len(keys) + 1, "cached_moduli": len(cached),
                       "secret_moduli_cached": 0, "rowmod_libraries": libs,
                       "plans_closed": len(plans)},
           "sizes": sizes_rec, "big": big, "kernels": kern,
           "seconds": time.perf_counter() - t_phase}
    emit("decrypt", what="entry_points", rows=rec["rows"], hygiene=rec["hygiene"],
         seconds=rec["seconds"])
    return rec


def kernel_times(sizes) -> dict:
    """CUDA-event ms of the B1, P, B3, B4, B5 and REDC launches at the
    timing phases' shapes (single launches with the stream held,
    `time_ms(hold=True)`), kernels only: the K_big and K_path mode-0 folds,
    one B `mul`, `mul` and `mul_nofinal` at B_probe, one exp launch
    (exponent n) at B_exp and at one client's width, one B launch of B4, B5
    and REDC, the K_path mode-1 and mode-2 folds, and the K_path folds of
    all three modes on the device level by level (`fold_levels`). Only
    public `mont_cuda` and `karatsuba` calls that the parent's package has
    too, so the same code times any tree's package (`--times --tree`); mode
    1's own launches around B4 are timed in the timing phase only."""
    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits

    dev = torch.device("cuda")
    key = bench_paillier_key(sizes["key_bits"])
    ctx = ModCtx.make(key.nsquare)
    t = time.perf_counter()
    started = [k.start_build() for k in mont_cuda.KERNELS]  # one nvcc each, at once
    for k, st in zip(mont_cuda.KERNELS, started):
        k.finish_build(*st)
        k.function()
    out = {"package": str(mont_cuda.CSRC.parent), "build_s": time.perf_counter() - t}
    for K, reps in ((sizes["K_big"], sizes["reps_big"]), (sizes["K_path"], sizes["reps_path"])):
        rows = bn.to_device(residues(ctx, K, 6 + K), dev)
        out[f"fold_K{K}_ms"], _ = time_ms(
            lambda: mont_cuda.reduce_mul(ctx, rows, karatsuba=False), reps, 2, dev)
    for B, seed in ((sizes["B"], 7), (sizes["B_probe"], 51)):
        a = bn.to_device(residues(ctx, B, seed), dev).T.contiguous()
        b = bn.to_device(residues(ctx, B, seed + 1), dev).T.contiguous()
        out[f"mul_B{B}_ms"], _ = time_ms(
            lambda: mont_cuda.mul(ctx, a, b, karatsuba=False), sizes["reps_path"], 2, dev,
            hold=True)
        if B == sizes["B_probe"]:
            out[f"mul_nofinal_B{B}_ms"], _ = time_ms(
                lambda: mont_cuda.mul_nofinal(ctx, a, b), sizes["reps_path"], 2, dev, hold=True)
    digits = torch.from_numpy(_exp_to_digits(key.n).astype(np.int32)).to(dev)
    out["E"] = len(digits)
    base = bn.to_device(residues(ctx, sizes["B_exp"], 34), dev).T.contiguous()
    for B in (sizes["B_exp"], sizes["ops_per_client"]):
        xb = base[:, :B].contiguous()
        out[f"exp_B{B}_ms"], _ = time_ms(lambda: mont_cuda.exp(ctx, xb, digits),
                                         sizes["reps_exp"], 1, dev)
    B = sizes["B"]
    a = bn.to_device(residues(ctx, B, 50), dev).T.contiguous()
    b = bn.to_device(residues(ctx, B, 51), dev).T.contiguous()
    out[f"kfused_B{B}_ms"], T = time_ms(lambda: mont_cuda.prod_kf(a, b),
                                        sizes["reps_path"], 2, dev, hold=True)
    out[f"redc_B{B}_ms"], _ = time_ms(lambda: mont_cuda.redc(ctx, T), sizes["reps_path"], 2,
                                      dev, hold=True)
    h = ctx.L // 2  # B4's six operands as row slices; canonical is all it needs
    c = bn.to_device(residues(ctx, B, 52), dev).T.contiguous()
    out[f"prod3_B{B}_ms"], _ = time_ms(
        lambda: mont_cuda.prod3(a[:h], b[:h], a[h:], b[h:], c[:h], c[h:]),
        sizes["reps_path"], 2, dev, hold=True)
    K = sizes["K_path"]
    rows = bn.to_device(residues(ctx, K, 6 + K), dev)
    for mode in ("k1", "fused"):
        out[f"fold_K{K}_{mode}_ms"], _ = time_ms(
            lambda: mont_cuda.reduce_mul(ctx, rows, karatsuba=mode), sizes["reps_path"], 2, dev)
    for mode in (False, "k1", "fused"):
        out[f"fold_K{K}_{mode or 'cios'}_device_ms"] = fold_levels(
            ctx, rows, dev, 5, mode)["device_ms"]
    return out


# run by `ab` in the root of each tree: that tree's own chip_smoke phases
# on its own package
PHASE_CHILD = """
import asyncio, json, sys
import torch
import chip_smoke
sizes, dev = json.loads(sys.argv[1]), torch.device("cuda")
for name in sys.argv[2].split(","):
    asyncio.run(getattr(chip_smoke, "phase_" + name)(dev, sizes))
"""


def float_leaves(prefix: str, d: dict) -> dict:
    """{"prefix.key.subkey": x} for every float x in the nested dict `d`."""
    out = {}
    for k, v in d.items():
        if isinstance(v, float):
            out[f"{prefix}.{k}"] = v
        elif isinstance(v, dict):
            out.update(float_leaves(f"{prefix}.{k}", v))
    return out


def ab(parent: str, phases: list[str]) -> int:
    """The tree at `parent` against this one in turns, parent, change,
    change, parent, each in a fresh process: the kernel times of
    `kernel_times` (`--times`), or with `phases` each tree's own chip_smoke
    phases of those names (e.g. e2e, client)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, tree in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        tree = os.path.abspath(tree)
        if phases:
            cmd = [sys.executable, "-c", PHASE_CHILD, json.dumps(CARD_SIZES), ",".join(phases)]
        else:
            cmd = [sys.executable, os.path.abspath(__file__), "--times", "--tree", tree]
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=1800,
                              check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return 1
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if phases:  # every number each phase reports, nested keys joined by "."
            rec = {k: v for d in lines if d.get("phase") in phases
                   for k, v in float_leaves(d["phase"], d).items()}
        else:
            rec = lines[-1]
        runs.append({"tree": label, **rec})
        emit("ab", **runs[-1])
    keys = [k for k in runs[0] if all(isinstance(r.get(k), float) for r in runs)]
    emit("ab_summary", order=[r["tree"] for r in runs],
         values={k: [r[k] for r in runs] for k in keys},
         change_over_parent={k: (runs[1][k] + runs[2][k]) / (runs[0][k] + runs[3][k])
                             for k in keys})
    print(nvidia_smi("name,power.limit"), flush=True)
    return 0


# the card's shapes: every timed shape is the main path's
CARD_SIZES = dict(key_bits=2048, B=4096, K_big=65536, K_path=8192, reps_big=5,
                  reps_path=20, reps_plain=2,
                  crossover=[8, 16, 32, 64, 128, 256, 512, 1024],
                  requests=6, rounds=3, B_exp_small=256, B_exp=8192, reps_exp=2,
                  rsa_bits=1024, clients=4, ops_per_client=2048, B_probe=8192,
                  K_coalesce=128, coalesce_burst=16, coalesce_rounds=3,
                  coalesce_min_batch=None, K_multall=16384,
                  crossover_l64=[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384],
                  mixed_replicas=7, mixed_quorum=5, mixed_preload=4096, mixed_clients=4,
                  mixed_ops=200, mixed_seed=7,
                  # the search phase: the write burst, warm reps a route, the
                  # cache-less baseline's reps, the plane alone at one full
                  # resident pool's rows
                  search_puts=64, search_writes=8, search_removes=8, search_reps=5,
                  search_baseline_reps=1, search_baseline_budget=300.0,
                  search_plane_rows=65536, search_plane_reps=20,
                  # configs/sharded.toml's [resident]; resident_fold.py's S and K
                  resident_groups=4, resident_initial=256, resident_max=65536,
                  resident_S=[1, 4], resident_K=[8192, 65536], resident_reps=3,
                  resident_new=256,
                  # analytics_matvec.py's R; the signed request's R; the slice
                  # held against the host loop
                  analytics_R=16, analytics_signed_R=4, analytics_slice=512,
                  # configs/stratum.toml's [resident] and [storage]; tiered_fold.py's
                  # pop-factor and theta
                  tier_groups=2, tier_max=4096, tier_chunk=256, tier_promote=2.0,
                  tier_max_promote=256, tier_pop_factor=10, tier_head=2048, tier_K=8192,
                  tier_theta=0.9, tier_reps=5, tier_warmup=3, tier_top=64,
                  # decrypt_throughput.py's sizes and B; the device plan at one
                  # and two full chunks; the rowmod parity's columns and digits;
                  # the plain ladder's columns
                  decrypt_bits=[1024, 2048], decrypt_B=256, decrypt_big=[4096, 8192],
                  decrypt_reps=3, rowmod_B=8192, rowmod_E=32, decrypt_plain_cols=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase tiny on the CPU (exits 3, no result)")
    ap.add_argument("--ab", metavar="PARENT",
                    help="time the B1/P/B3/B4/B5/REDC kernels and the folds of the tree at "
                         "PARENT and of this one in turns (parent, change, change, "
                         "parent); no result line")
    ap.add_argument("--phases", default="",
                    help="with --ab: run these chip_smoke phases of each tree instead "
                         "(comma-separated, e.g. e2e,client)")
    ap.add_argument("--times", action="store_true",
                    help="print one JSON line of kernel times (used by --ab)")
    ap.add_argument("--tree", help="with --times: time the dds_tpu_torch of this tree")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    import torch

    if (args.ab or args.times) and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.ab:
        return ab(args.ab, [p for p in args.phases.split(",") if p])
    if args.times:
        if args.tree:  # before anything imports dds_tpu_torch
            sys.path.insert(0, args.tree)
        print(json.dumps(kernel_times(CARD_SIZES)), flush=True)
        return 0
    if args.rehearse:
        dev = torch.device("cpu")
        sizes = dict(key_bits=512, B=64, K_big=512, K_path=256, reps_big=1,
                     reps_path=2, reps_plain=1, crossover=[8, 32], requests=2,
                     rounds=1, B_exp_small=8, B_exp=16, reps_exp=1, rsa_bits=512,
                     clients=2, ops_per_client=64, B_probe=64, K_coalesce=16,
                     coalesce_burst=16, coalesce_rounds=2, coalesce_min_batch=32,
                     K_multall=64, crossover_l64=[8, 32], mixed_replicas=7, mixed_quorum=5,
                     mixed_preload=64, mixed_clients=2, mixed_ops=40, mixed_seed=7,
                     search_puts=8, search_writes=4, search_removes=4, search_reps=2,
                     search_baseline_reps=1, search_baseline_budget=60.0,
                     search_plane_rows=2048, search_plane_reps=2,
                     resident_groups=4, resident_initial=16, resident_max=1024,
                     resident_S=[1, 4], resident_K=[64, 256], resident_reps=1,
                     resident_new=16, analytics_R=16, analytics_signed_R=4,
                     analytics_slice=64, tier_groups=2, tier_max=32, tier_chunk=16,
                     tier_promote=2.0, tier_max_promote=16, tier_pop_factor=10,
                     tier_head=32, tier_K=256, tier_theta=0.9, tier_reps=2,
                     tier_warmup=3, tier_top=4, decrypt_bits=[512], decrypt_B=16,
                     decrypt_big=[32, 64], decrypt_reps=1, rowmod_B=64, rowmod_E=8,
                     decrypt_plain_cols=8)
        card = {"name": "cpu (rehearsal)", **card_numbers(dev)}
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        dev = torch.device("cuda")
        sizes = CARD_SIZES
        card = {
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            **card_numbers(dev),
            "smi": nvidia_smi("name,power.limit"),
            "clocks_now": nvidia_smi("clocks.sm,power.draw,temperature.gpu"),
        }
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda)

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.ops.montgomery import ModCtx

    ctx = ModCtx.make(bench_paillier_key(sizes["key_bits"]).nsquare)
    phase_build(args.rehearse)
    par = phase_parity(ctx, dev, sizes)
    par_k = phase_parity_karatsuba(ctx, dev, sizes, par["k_rows"])
    par_nf = phase_parity_nofinal(ctx, dev, sizes)
    par_exp = phase_parity_exp(ctx, dev, sizes)
    par_rm = phase_parity_rowmod(dev, sizes)
    tim = phase_timing(ctx, dev, sizes, card)
    tim_k = phase_timing_karatsuba(ctx, dev, sizes, card)
    tim_exp = phase_timing_exp(ctx, dev, sizes, card)
    phase_crossover(dev, ctx.n, sizes["crossover"])
    e2e = asyncio.run(phase_e2e(dev, sizes))
    asyncio.run(phase_coalesce(dev, sizes))
    client = asyncio.run(phase_client(dev, sizes))
    decrypt = phase_decrypt(dev, sizes, client, card)
    multall = asyncio.run(phase_multall(dev, sizes))
    mixed = asyncio.run(phase_mixed(dev, sizes))
    plane = phase_search_plane(dev, sizes)
    resident = asyncio.run(phase_resident(dev, sizes))
    tiered = asyncio.run(phase_tiered(dev, sizes))

    path = tim["path"]
    # the fold kernels' single launches at MultAll's width, L = 64
    l64 = {name: {"L": 64, "B": sizes["B"], **t}
           for name, t in multall["launches_L64"].items()}
    kernels = [{
        "name": "mont_mul",
        "route": "cuda",
        "source": "dds_tpu_torch/csrc/mont_mul.cu",
        "replaces": "dds_tpu/ops/mont_mxu.py:119",
        "tpu_twin": "mont_mxu._make_prod_kernel + _redc (v2); pallas_mont._make_mul_kernel (v1)",
        "launches_by_path": {"sumall": e2e["launches"],
                             "analytics": e2e["analytics"]["modes"]["0"]["launches"]["mont_mul"],
                             "analytics_rest":
                                 resident["rest"]["matvec"]["launches"]["mont_mul"],
                             "multall": multall["modes"]["0"]["launches"]["mont_mul"],
                             "mixed": mixed["mont_mul_launches"],
                             "resident": resident["modes"]["0"]["launches"]["mont_mul"],
                             "resident_rest":
                                 resident["rest"]["modes"]["0"]["launches"]["mont_mul"],
                             "tiered": tiered["modes"]["0"]["launches"]["mont_mul"],
                             "tiered_rest": tiered["rest"]["launches"]["mont_mul"]},
        "max_abs_err": par["max_abs_err"],
        "per": f"one K={path['K']} fold ({path['launches']} launches) on the device; "
               f"wall_ms: back to back, paced by the host's dispatch",
        "ms": path["device_ms"],
        "wall_ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": None,
        "L64": l64["mont_mul"],
    }, {
        "name": "mont_exp",
        "route": "cuda",
        "source": "dds_tpu_torch/csrc/mont_exp.cu",
        "replaces": "dds_tpu/ops/pallas_mont.py:152",
        "tpu_twin": "pallas_mont._make_exp_kernel via _exp_call / exp_lm",
        "launches_by_path": {"client": client["exp_launches"]},
        "max_abs_err": max(par_exp["max_abs_err"], tim_exp["max_abs_err"]),
        "per": f"one launch, B={tim_exp['B']}, E={tim_exp['E']} "
               f"({tim_exp['exp_products_per_row']} products per row)",
        "ms": tim_exp["exp_ms"],
        "plain_ms": tim_exp["plain_ms"],
        "bound_ms": tim_exp["exp_bound_ms"],
        "bound_by": tim_exp["exp_bound_by"],
        "library_ms": None,
    }]
    dk = decrypt["kernels"]
    for name, replaces, twin in (
        ("mont_mul_rowmod", "dds_tpu/ops/montgomery.py:115",
         "montgomery._mont_mul_rowmod_raw (XLA, not a Pallas kernel) in "
         "sanctum/device.py::_fused_crt_raw (:95)"),
        ("mont_exp_rowmod", "dds_tpu/ops/montgomery.py:155",
         "montgomery._mont_exp_rowdigits_raw (XLA, not a Pallas kernel) in "
         "sanctum/device.py::_fused_crt_raw (:95)")):
        t = dk[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "dds_tpu_torch/csrc/mont_rowmod.cu",
            "replaces": replaces, "tpu_twin": twin,
            "launches_by_path": {"decrypt": decrypt["rows"]["launches"][name]},
            "max_abs_err": max(par_rm["max_abs_err"], t["max_abs_err"]),
            "per": f"one launch, {dk['columns']} columns ({dk['columns'] // 2} ciphertexts), "
                   f"L={dk['L']}" + (f", E={dk['E']}; plain_ms on {t['plain_columns']} "
                                     f"columns" if name == "mont_exp_rowmod" else ""),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    # each Karatsuba kernel's launches on the SumAll e2e run, MultAll's run,
    # the resident plane's folds and SumAlls and the tiered folds, in its mode
    k1, kf = ({k: {"sumall": e2e["karatsuba_modes"][m]["launches"][k],
                   "analytics": e2e["analytics"]["modes"][m]["launches"][k],
                   "multall": multall["modes"][m]["launches"][k],
                   "resident": resident["modes"][m]["launches"][k],
                   "resident_rest": resident["rest"]["modes"][m]["launches"][k],
                   "tiered": tiered["modes"][m]["launches"][k]} for k in KARATSUBA_KERNELS}
              for m in ("1", "2"))
    for name, replaces, twin, launches, err, per in (
        ("mont_prod3", "dds_tpu/ops/mont_mxu.py:151",
         "mont_mxu._make_prod3_kernel via _prod3_call (DDS_KARATSUBA=1)",
         k1["mont_prod3"], par_k["max_abs_err"]["mont_prod3"], f"one launch, B={sizes['B']}"),
        ("mont_k1_halfsums", "dds_tpu/ops/mont_mxu.py:406",
         "mont_mxu.carry_norm of the half sums in prod_lm_k1 (XLA, not a Pallas kernel)",
         k1["mont_k1_halfsums"], par_k["max_abs_err"]["mont_k1_halfsums"],
         f"one launch, B={sizes['B']}"),
        ("mont_k1_combine", "dds_tpu/ops/mont_mxu.py:188",
         "mont_mxu.carry_norm of z0, z2 and _karatsuba_combine in prod_lm_k1 (XLA, not a "
         "Pallas kernel)", k1["mont_k1_combine"], par_k["max_abs_err"]["mont_k1_combine"],
         f"one launch, B={sizes['B']}"),
        ("mont_kfused", "dds_tpu/ops/mont_mxu.py:218",
         "mont_mxu._make_kfused_kernel via _kfused_call (DDS_KARATSUBA=2)",
         kf["mont_kfused"], par_k["max_abs_err"]["mont_kfused"], f"one launch, B={sizes['B']}"),
        ("mont_redc", "dds_tpu/ops/mont_mxu.py:543",
         "mont_mxu._redc (XLA, not a Pallas kernel): the reduction of modes 1 and 2",
         {f"{path}_mode{m}": n for m, kd in (("1", k1), ("2", kf))
          for path, n in kd["mont_redc"].items()}, par_k["max_abs_err"]["mont_redc"],
         f"one launch, B={sizes['B']}"),
        ("mont_mul_nofinal", "benchmarks/profile_kernel.py:33",
         "profile_kernel.make_nofinal_mul (the finalize-share probe)",
         {"probe": tim_k["mont_mul_nofinal"]["launches"]}, par_nf["max_abs_err"],
         f"one launch, B={sizes['B_probe']}"),
    ):
        t = tim_k[name]
        source = {"mont_mul_nofinal": "mont_mul", "mont_k1_halfsums": "mont_k1",
                  "mont_k1_combine": "mont_k1"}.get(name, name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"dds_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "tpu_twin": twin, "launches_by_path": launches,
            "max_abs_err": err, "per": per, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            **({"L64": l64[name]} if name in l64 else {}),
        })
    for k in kernels:  # the total launches, each path's zeroed and read apart
        k["launches"] = sum(k["launches_by_path"].values())
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    print(json.dumps({"kernels": kernels}), flush=True)
    rest = mixed["search"]
    calls = collections.Counter(rest["predicate_calls"])
    for label in ("mixed", "default"):
        calls.update(mixed["rounds"][f"{label}.cuda_search"]["predicate_calls"])
    ops = {name: {"replaces": PREDICATE_OPS[name][1],
                  "route": "PyTorch ops (XLA in the reference, no Pallas twin)",
                  "source": "dds_tpu_torch/ops/predicate.py",
                  "calls": calls[name],
                  "calls_per_query": {r: t["predicate_calls"][name] / t["queries"]
                                      for r, t in rest["indexed"].items()
                                      if t["predicate_calls"][name]},
                  **plane["ops"][name]} for name in PREDICATE_OPS}
    missing = [name for name, op in ops.items() if op["calls"] <= 0]
    if missing:
        raise AssertionError(f"predicate ops the indexed stack never called: {missing}")
    print(json.dumps({"search": {
        "ops": ops, "rest_queries": rest["queries"],
        "routes_ms": {r: {"indexed": rest["indexed"][r]["median_ms"],
                          "legacy": rest["legacy"][r]["median_ms"],
                          "baseline_no_cache": rest["baseline_no_cache"].get(r, {}).get(
                              "median_ms")} for r in rest["indexed"]},
        "rounds": rest["rounds"], "plane_build_ms": plane["build_ms"],
        "phase_seconds": rest["seconds"] + plane["seconds"],
        "run_seconds": time.perf_counter() - t_run}}), flush=True)
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
