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
search plane's indexed Search*/Order*/Range routes, the Sanctum
decrypt (both CRT legs of a batch on the per-column-modulus kernels), the
dependability plane (SumAlls folding on the card through proactive,
byzantine and crash recoveries, snapshots and anti-entropy) and
configs/default.toml served as it stands with Bulwark admission control,
the SLO engine and the Watchtower auditor through an overload window,
configs/tenancy.toml's Bastion tenancy (each tenant folding under its
own Paillier-2048 modulus, a noisy neighbour, a crypto-shred) and
configs/heliograph.toml's active canary (golden transactions decrypted
and verified beside user folds on the card, the corruption drill) and
configs/sharded.toml's and configs/stratum.toml's Constellations (shard
groups behind a router, scatter-gather folds on the card) and
configs/default.toml over a seeded ChaosNet with Nemesis armed and the
proxy's stored-keys snapshot (SumAlls exact on the card through link
faults, delays, partitions, a flood and a proxy restart) and
configs/sharded.toml reshaped live (Helmsman's merge of a cold group,
an operator's split onto the warm standby through POST /_reshard, every
SumAll exact on the card across both) and the device mesh (the sharded
folds, the sharded modexp and the resident plane's multi-device fold over
D slots of the card, a SumAll served through it) — and holds
every CUDA kernel on them against its plain PyTorch version. The phases
before `recovery` turn the audit and /slo off in the configs they build
(EARLIER_OBS_CUTS), and every phase before `tenancy` runs with the
process-wide Chronoscope off (CHRONOSCOPE_CUT), both printed on the "cuts"
line, so their numbers compare with the runs before those planes were
ported; for the run's time the mixed, multall, recovery, bulwark,
resident and tiered phases run at a smaller depth than their sources
(MIXED_CUT, DEPTH_CUTS, printed there too; the sizes below are the
sources'). Phases, each printing one JSON line; any failure exits
non-zero:

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
              launch alone, beside the bound, the plain ladder on the
              launch's first 1,024 columns (timed once, and bit-exact
              against the launch there; cut from all 8,192 for the run's
              time, printed), and host Python `pow`;
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
              dispatch ms, beside its plain version and its bound; then
              ("audited") the mode-0 rounds again with the Watchtower
              attached and /slo on: their ms beside the plain rounds',
              the auditor's ops and no violation, the launches (path
              "sumall_audited");
12. coalesce  a fresh stack with K = 128 rows (below min_device_batch) and
              the 2 ms window: 3 rounds of 16 concurrent SumAlls, each
              decrypting to the total, at least one `fold_many` pass of 2 or
              more folds launching mont_mul; then the burst with the window
              off; then ("adaptive") the same rows (8 in flight) and
              bursts on a stack with [admission] and adaptive-coalesce on
              (base 2 ms, cap 20 ms, 8 folds a pass), the bursts once the
              shed ratchet is at 0: every SumAll exact, each burst with a
              fold_many pass of 2 or more folds launching mont_mul, each
              drain's window within [2, 20] ms;
13. client    `run.load_provider` with `bulk-encrypt-backend = "cuda"`, then
              4 `DDSHttpClient`s each PutSet 1,024 rows (K = 4,096 in all;
              cut from 2,048 a client for the run's time, DEPTH_CUTS)
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
              `HomoProvider.decrypt_rows` over its 4,096 stored rows read
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
              --clients 4 --ops 200, the preload cut to 1,024 rows and
              the ops to 25 a client for the run's time, MIXED_CUT): 7
              replicas, quorum 5; the preload's
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
              legacy scan with the tag-validated cache off, its SearchGt
              case); then
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
              fold past the cap: one reset, still exact (its REST level is
              configs/sharded.toml's launch in the sharded phase,
              DEPTH_CUTS);
17. tiered    Stratum (configs/stratum.toml's [resident] and [storage],
              benchmarks/tiered_fold.py): 2 groups, max-rows 4,096, a
              population of 10 x max-rows per group, warm-bytes cut to
              max-rows x 10 x 16 (printed), the segment log in a temporary
              directory; the population fold and Zipf(0.9) folds over each
              group's 2,048-row head, exact, no reset, cold reads, the head's
              most drawn rows promoted back to hot; the all-resident ceiling
              against the tiered fold; one fold in modes 1 and 2 (its REST
              level is configs/stratum.toml's launch in the sharded phase,
              DEPTH_CUTS);
18. recovery  configs/default.toml's [replicas] and [recovery] as they
              stand (9 endpoints, 2 sentinent spares, quorum 5, f = 2,
              warm-up 5 s, interval 7 s, verified transfer, 256-key
              chunks, anti-entropy at the reference's default, on) on
              `cuda`, /metrics on, the flight recorder in a
              temporary directory, Trudy armed; cut (printed): [admission],
              the obs audit and the SLO route. K = 8,192 rows by quorum
              PutSet; SumAlls until 2 proactive recoveries completed; Trudy
              turns f = 2 active replicas byzantine (window "byzantine",
              until both are out of the active list); Trudy crashes the
              replica the proactive timer takes next, which is redeployed
              and reseeded (window "crash"); the active replicas holding
              each acknowledged row counted; save_all of the 9 replicas and
              a second generation of replica-0 with one bit flipped; a
              second deployment (no proactive timer) restores them at
              launch (the flipped
              file quarantined, generation 1 loaded), every acknowledged
              PutSet read back through it, a SumAll over the restored
              state, an in-sync and a
              repairing anti-entropy round, a promoted stale spare
              converging; /health (200, a recovery section) and /metrics
              (supervisor, anti-entropy and snapshot families) on both.
              Every SumAll decrypts to the total, equals the Python-int
              fold and launches B1 (mont_mul); 0 failed operations outside
              the fault windows, every failure listed;
19. bulwark   configs/default.toml as it stands on `cuda` (printed
              overrides: the backend, and the bench key's Paillier-2048
              data): 9 endpoints, 2 spares, quorum 5, recovery and
              anti-entropy on, [admission] (interactive 400/800, aggregate
              64/128, background 16/32, eval 1 s, shed-hold 3, max level 2,
              fast-fail, adaptive coalescing 2-20 ms at 8 folds), the audit
              with quorum checks and /slo with its per-route objectives.
              K = 8,192 rows by PutSet through the admitted edge, 8 in
              flight (within the file's 250 ms PutSet objective), each 429
              honoured by its Retry-After; steady SumAlls; then
              overload_goodput.py's open-loop schedule without ChaosNet
              for 10 s (seed 11), its clients on their own event loop in a
              thread: GetSets of stored keys at 30/s and a SumAll flood at
              400/s, /health, /metrics and /slo probed each second; then a
              5 s tail of single SumAlls. Before the flood, once the
              ratchet is back at level 0, a burst of 48 background-class
              requests (`/_sync`, 404 once admitted) past the class's
              burst of 32. Gates: every 200
              SumAll the exact fold (B1 launched on the path, each steady
              one on its own), every 200 GetSet its row, every rejection a
              429 or 503 with Retry-After >= 1 and the admission body, a
              429 past the background burst, SumAlls of the flood refused
              (429 or shed 503), issued = admitted + rejected against the
              controller's counters, the probes 200, the Watchtower
              attached with audited ops and no violation, no 500. Printed:
              goodput, statuses by route, the shed transitions, the
              proxy.admission span, degraded 503s by kind, the adaptive
              window, the audit, the SLO burns, the phase's seconds beside
              its 150 s budget;
20. tenancy   configs/tenancy.toml as it stands on `cuda` (printed
              overrides: the backend, an OS-assigned port, the phase's
              data): 4 replicas, quorum 3, [tenancy] (gold 3.0, batch-etl
              0.5), [admission] (interactive 400/800, aggregate 64/128),
              /slo, the audit, Chronoscope. Four victims (gold, tenant-00,
              tenant-01, batch-etl) and a flooder, each with its own
              family from TenantKeyring(2048, 1024) (key generation
              timed): 1,024 rows a victim and 256 for the flooder (cut
              from 2,048 and 512 for the run's time, DEPTH_CUTS), blinded
              on the card (one B3 pow_mod a tenant) and written by PutSet
              under the tenant's header, 8 in flight; one SumAll a victim,
              then the four at once, each the Python fold of exactly its
              own rows under its own n^2, decrypting to its total, with
              its B1 launches (11 at K = 1,024); the isolation gates (a
              typed 403 for a cross-tenant GetSet and for a PutSet
              replaying another tenant's content, a SumAll under another
              tenant's n^2 folding only the caller's rows, 2 canary rows
              folded only by the canary, /health's owned keys, /metrics'
              dds_tenant_stored_keys a tenant, /slo's tenants,
              Chronoscope's usage of every tenant); the backend's device
              stores, one a modulus (count and bytes); the shred drill
              mid-traffic (rotate tenant-01, re-encrypt a row and decrypt
              it under epoch 2, shred): the survivors' reads and SumAlls
              exact, the shredded tenant's rows served, every access to
              its keys TenantShredded, 0 Watchtower violations; then
              tenant_isolation.py's noisy neighbour at the file's rates
              (victims drawn Zipf(1.2), GetSets of their own rows at 40/s,
              10 % their own SumAll, a 10 s window; run A alone, run B
              with flood SumAlls at 256/s from 2 s before the window; the
              clients on their own loop): the victims' GetSet p50/p95 a
              run and the ratio (the reference's bar 1.10, printed, not
              gated), the flooder's statuses, whether shed_tenants() named
              it; gates: every 200 SumAll exact, every refusal a 429 or 503
              with Retry-After >= 1, no victim GetSet 429, no 500, 0
              Watchtower violations over the whole phase; the phase's
              seconds beside its 150 s budget;
21. heliograph configs/heliograph.toml as it stands on `cuda` (printed
              overrides: the backend, an OS-assigned port, the east and
              west targets failing as unresolvable names without a lookup,
              the phase's data): 4 replicas, quorum 3, the prober at the
              file's cadence 5 s (jitter 0.5, deadline 2 s, slow-ms 250,
              population 4 under 512-bit canary keys, the five probe kinds,
              the loopback then east and west, streak 3), the audit,
              /metrics, /slo. The first probe cycle on the canary-only
              store, every kind ok and no B1 launch; the drill there
              (benchmarks/canary_overhead.py's: the prober's loop driven at
              0.25 s, one canary PSSE ciphertext corrupted in place on every
              replica, a GetSet of it still 200, loopback cycles counted
              until the sum probe reads wrong_answer (and on until east and
              west stand at their streak of 3), the Watchtower's
              verdicts only canary_wrong_answer, one of them /canary's
              exemplar; then the row re-put by a putget and the sum probe
              ok again); K = 4,096 rows (8,192 cut for the run's time,
              DEPTH_CUTS) of the bench key blinded on the card
              (B3) and loaded by PutSet 64 in flight with the prober
              running; 6 user SumAlls, each the Python fold of exactly the
              K rows (no canary row) and decrypting to the total, 13 B1
              launches each (14 at 8,192); the kernel sentry's cuda:: rows of those folds
              written as the baseline file (DDS_KERNEL_BASELINE, else the
              port's dds_tpu_torch/kernel_baseline.json) and 3 more
              SumAlls compared against it (printed, not gated);
              canary_overhead.py's shape: a 10 s open-loop window of GetSets
              (30/s) and SumAlls (2/s) with the prober off, then on, each
              SumAll exact, overhead_pct beside the reference's 1 % bar
              (printed, not gated); the routes /profile, ?fmt=folded,
              /canary, POST /_sync, /_trace (404: the file's debug is off),
              /health's canary section, /metrics' dds_canary_*, /slo's
              canary.<kind> streams. Gates: B1's launches over the phase
              exactly one a fold level (13) a user SumAll plus the blinding's, 0 in the
              probe-only windows; east and west at their streak of 3; no
              500. Printed: verdicts by kind and target, probe latencies,
              the phase's seconds beside its 120 s budget;
22. sharded   configs/sharded.toml as it stands on `cuda` (printed
              overrides: the backend, an OS-assigned port, the phase's
              data, the scatter rounds' resident min fold): a
              Constellation of 4 groups x (4 replicas + 1 spare), quorum 3,
              f = 1, proactive recovery and anti-entropy in each group,
              [resident] 256 / 65,536 rows, [analytics], the audit. K =
              4,096 rows (cut from bft_sum's 8,192 for the phase's 90 s,
              DEPTH_CUTS) blinded on the card (B3) and loaded by PutSet 64
              in flight; 6 SumAlls through the fused S = 4 resident tree
              (B1: the tree's levels, 14 a SumAll), 2 in each of the
              Karatsuba modes 1 and 2 (only that mode's kernels), then 6
              through the scatter fold (one device fold a group,
              combine_partials), each the Python-int fold of the K
              ciphertexts and decrypting to the total, p50/p95 of each;
              256 rows written once the pools exist and a SumAll ingesting
              0 rows on its fold path; one REST MatVec (R = 16) scattered
              over the 4 groups, each group's columns gathered once
              through the plane's rows_for, its B1 launches the groups'
              weighted ladders, equal row by row to the port's unsharded
              evaluate on the marshaling path (not counted) and decrypting
              to W @ x; GET /shards (4 groups, ETag "1", 304 on If-None-Match),
              /health's shard_epoch 1 and reshard_state stable, /metrics'
              dds_shard_*, POST /_reshard 404; a stale-epoch IWrite sent
              straight to a replica of a non-owning group, answered by a
              WrongShard whose MAC verifies and stored nowhere. Then
              configs/stratum.toml (2 groups, [storage] in a temporary
              directory, the hot tier cut to 512 rows a group and the warm
              tier to 80 rows, printed): 2,048 rows blinded on the card
              (before the path's counts start), three SumAlls through
              Stratum (proxy.resident_fold) streaming the warm and cold
              legs, exact, no reset, B1 launched by each; the dds_tier_*
              gauges. B1's launches on the paths "sharded" and "stratum"
              and B3's on "sharded" > 0 on the card, the Karatsuba
              kernels' on "sharded"; no 500; the phase's seconds beside
              its 90 s budget;
23. chaos     configs/default.toml as it stands on `cuda` over a ChaosNet
              (printed overrides: the backend, [attacks] enabled and
              chaos-enabled with chaos-seed 19, [proxy] stored-keys-path
              in a temporary directory, the data, the loader at 8 in
              flight for the file's PutSet objective): 9 endpoints, 2
              spares, quorum 5, f = 2, proactive recovery, anti-entropy,
              Bulwark, the audit, Nemesis armed. 1,024 rows (cut from
              2,048 for the run's time, DEPTH_CUTS) blinded on
              the card (B3) and loaded by PutSet on a clean fabric; then
              CHAOS_SCHEDULE: a clean SumAll; link faults on every link
              (drop, duplicate and reorder 0.02, corrupt 0.01) with 8
              PutSets and 3 SumAlls, the trace's actions counted; Nemesis
              delay, partition (with 8 PutSets) and flood of f victims
              drawn from the active replicas, 3 SumAlls each; heal, every
              endpoint but quorum - 1 replicas cut off under a 2 s request
              budget (the SumAll answers 503 with Retry-After), heal and a
              SumAll; the proxy stopped and a fresh one started on the same
              replicas, quorum client and snapshot: its stored keys every
              acknowledged key, its first SumAll the last one's ciphertext
              (retries after 503 + Retry-After counted); every
              acknowledged PutSet read back. Gates: every 200 SumAll the
              Python-int fold of the acknowledged rows, decrypting to their
              total, with one B1 launch a fold level (11 at 1,024 rows, 12
              past it), B1 on the path the SumAlls' levels plus the
              blinding's 2 and B3 1, every non-200 a 503 or 429 with
              Retry-After, 0 Watchtower violations. Printed: each step's
              SumAll ms (p50/p95), retries, victims and trace counts, the
              phase's seconds beside its 60 s budget;
24. reshard   configs/sharded.toml on `cuda` with live resharding and
              Helmsman (printed overrides: the backend, an OS-assigned
              port, [fabric] admin-routes, [shard] plan-dir in a temporary
              directory, [helmsman] enabled and pinned at a 1 s interval,
              cold-streak 3, cooldown 5 s, the data, the loader at 8 in
              flight): 2,048 rows blinded on the card (B3, with 320
              candidate rows for the split) and loaded while Helmsman is
              pinned (3 ticks, no action, /health's helmsman block);
              POST /_helmsman unpins it (the SLO alerts, shed level and
              open breakers printed first; a distressed fleet fails) and
              GetSets over s0-s2's keys run until it merges the cold s3
              (20 s deadline; epoch 2, s3 a warm standby holding none of
              the moved keys), then it is pinned again; SumAlls at S = 3
              on the fused tree and scattered; POST /_reshard splits s0
              onto s3 while 4 writers PutSet 32 rows the split moves (held
              behind the Rebalancer's lock until a different plan answered
              409 busy with Retry-After and an identical one attached; the
              replay answers epoch 3); SumAlls at S = 4; every row read
              back; /shards verifying at epoch 3, the plan directory empty,
              dds_helmsman_actions_total{action="merge"} 1, the aborts
              counted. Gates: each SumAll the Python-int fold of the
              acknowledged rows, decrypting to their total, its B1 launches
              the fused tree's levels over the proxy's owner partition (equal
              to the live map's) or one device fold a group; B1 on the path
              the SumAlls' plus the blinding's 2, B3 1; every write
              acknowledged; 0 Watchtower violations; no 500. Printed: each
              reshape's wall time, moved keys and bytes, each group's pool
              rows, the wrong-shard retries, the phase's seconds beside its
              75 s budget;
25. mesh      the device mesh (`parallel/mesh`) at L = 256 on
              `Mesh([cuda:0] * D)`, D slots on the one card (printed
              overrides for its served SumAll): the sharded fold at
              K = 8,192 and 8,191 on D = 1-4 slots, both combines (all_gather
              and ring), mode 0, and at D = 4 modes 1 and 2; the sharded
              modexp at B = 8,192 with the bench key's n (E = 512) at D = 4
              and through `CudaBackend.powmod_batch` at B = 8,190 (padded);
              `modmul_fold_resident` over 8,192 ints; the resident plane
              with 4 groups of 2,048 at D = 2, 4 and 3, each group's rows
              folded on its pool's slot (group i on slot i mod D); 3
              SumAlls served by sharded.toml's 4 groups with the backend
              built on the 4-slot mesh, so the plane places each group's
              pool on its own slot, 2,048 rows (cut from 8,192,
              DEPTH_CUTS); DDS_MESH=4, which truncates to the cards that
              exist. Gates: every result bit for bit the flat path's and
              the Python-int product (64 modexp columns Python `pow`, each
              SumAll decrypting to the total); each call's launches
              (zeroed before, read after) the formulas
              `mesh_fold_launches`, 2D B1 + D B3 a modexp, the flat fold's
              14 under DDS_MESH=4 on one card.
              Printed: each call's device, dispatch and wall ms beside the
              flat call's, the bound of its products, the phase's seconds
              beside its 45 s budget;
26. kernels   one {"kernels": [...]} line (every kernel must have launched
              on its path; the fold kernels also carry their L = 64
              launch; the analytics requests' launches are the path
              "analytics", the rowmod kernels' the
              path "decrypt", `decrypt_rows`' run, B1's the paths
              "recovery", "sumall_audited", "bulwark", "tenancy",
              "heliograph", "sharded" (its MatVec included), "stratum",
              "chaos", "reshard", "mesh" and "mesh_sumall", B3's "client",
              "tenancy", "heliograph", "sharded", "chaos", "reshard" and
              "mesh", the Karatsuba kernels' also "sharded" and "mesh");
              then one
              {"search": ...}
              line: each predicate op's calls on the indexed stack (gates,
              timing and rounds), calls a query, held ms, bound and rows/s
              at 65,536 rows, each route's warm ms on both paths and the
              baseline, the rounds' ops/s on both stacks, the phase's and
              the run's seconds; then one {"recovery": ...} line: SumAll
              p50/p95 with and without a recovery in flight, each
              recovery's trigger, wall time (trigger to
              `wait_recovery_idle`), StateChunks, keys and bytes, the fault
              windows and their failures, the snapshot and anti-entropy
              figures, the phase's seconds beside its 150 s budget; then
              one {"bulwark": ...}, one {"tenancy": ...}, one
              {"heliograph": ...}, one {"sharded": ...}, one
              {"chaos": ...}, one {"reshard": ...} and one {"mesh": ...}
              line with those phases' whole records;
              then the card's name and power limit;
              then the result line.

    python3 chip_smoke.py              # on the card (needs one GPU)
    python3 chip_smoke.py --rehearse   # the same phases, tiny, on the CPU;
                                       # exits 3 and prints no result
    python3 chip_smoke.py --ab PARENT [--phases e2e,client,multall,mixed,resident,tiered]
        # on the card: another checkout (PARENT) against this one in turns,
        # parent, change, change, parent: the B1/P/B3/B4/B5/REDC kernel
        # times and the folds of every mode, or each tree's own chip_smoke
        # phases; prints no result line
    python3 chip_smoke.py --phases sharded [--size sharded_K=8192 ...]
    python3 chip_smoke.py --phases chaos
    python3 chip_smoke.py --phases reshard
    python3 chip_smoke.py --phases mesh
        # on the card: the named phases alone at the card's sizes (each
        # --size changes one), each followed by its seconds; no result line

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
import concurrent.futures
import json
import math
import random
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
    # the plain ladder on the first `exp_plain_cols` columns only (a cut
    # of the run's time, printed; the kernel is held against it there)
    cols = min(B, sizes["exp_plain_cols"])
    plain_ms, want = time_ms(lambda: ctx.mont_exp(bases[:cols], digits).T, 1, 0, dev)
    err = int((got[:, :cols].long() - want.long()).abs().max())
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
           "max_abs_err": err, "plain_ms": plain_ms, "plain_columns": cols,
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


# The earlier phases keep what they measured before the REST edge's
# planes were ported: the Watchtower audit and the /slo route, on by
# default now, are turned off in every DDSConfig() they build (main prints
# this); the recovery phase keeps its own RECOVERY_CUTS.
EARLIER_OBS_CUTS = {"obs.audit_enabled": False, "obs.slo_route": False}
# every phase before `tenancy` runs with the process-wide Chronoscope off
# (its DDS_OBS_PIPE=0 switch, set in-process), so those phases' numbers
# compare with the runs before `launch` attached it
CHRONOSCOPE_CUT = "off before the tenancy phase (chronoscope.enabled = False)"
# the mixed phase's depth, cut for the run's time (PR 13: 200 ops a client
# to 50; PR 15: 50 to 25 and the preload of 4,096 rows to 2,048, which
# halves the preloads and the cache-less search baseline, 62.5 s of one
# query over 4,192 keys in PR 15's first full run of 1,065 s)
# once the chaos phase joined (a full run of 913.0 s against the 900 s
# mark, mixed 94.4 s of it; H100 80GB HBM3, 700 W), 2,048 -> 1,024 rows,
# which took 22.8 s off the phase in a paired run before
MIXED_CUT = {"preload": "4096 -> 2048 -> 1024 rows", "ops_per_client": "200 -> 25"}
# the depth of other earlier paths, cut for the run's time once the
# tenancy phase joined (a full run took 1,528 s on a slow host: recovery
# 214 s, bulwark 154, resident 89, tiered 84, multall 63), and again once
# the heliograph phase joined (its full runs took 1,101.6 s and 1,157.6 s
# on slow hosts: the tenancy load 86.7 s at 8 in flight; the recovery load
# and read-back 47 and 33 s, the bulwark load 50 s, at 4,096 rows)
# once the sharded phase joined, the REST stacks of the resident and tiered
# phases (8,192 PutSets each) gave way to configs/sharded.toml's and
# configs/stratum.toml's launches there, which serve the same SumAlls,
# MatVec and post-write ingest through the files' own planes
DEPTH_CUTS = {"multall.K": "16384 -> 8192 records",
              "recovery.K": "8192 -> 4096 -> 2048 rows",
              "bulwark.K": "8192 -> 4096 -> 2048 rows", "resident.reps": "2 -> 1",
              "tiered.reps": "3 -> 2",
              "tenancy.rows": "2048 -> 1024 a victim, 512 -> 256 the flooder",
              # the phase took 73.1 s of its 90 s at 8,192 rows (sharded.toml
              # 56.2 s, its load 43.2 s of it; stratum.toml 16.9 s; H100 80GB
              # HBM3, 700 W); loads of one size ran up to 1.7x slower from one
              # host to another
              "sharded.K": "8192 -> 4096 rows",
              # with the chaos phase the full run took 913.0 s, heliograph
              # 64.1 s of it; 4,096 rows took 33.1 s off the phase in a
              # paired run before (H100 80GB HBM3, 700 W)
              "heliograph.K": "8192 -> 4096 rows",
              "resident.rest": "the REST stack (8192 rows) -> configs/sharded.toml's "
                               "launch in the sharded phase",
              "tiered.rest": "the REST stack (8192 rows) -> configs/stratum.toml's "
                             "launch in the sharded phase",
              # the mesh phase's served SumAll, for its 45 s budget
              "mesh.sumall_K": "8192 -> 2048 rows",
              # once the mesh phase joined, the full run took 919.1 s, the
              # client phase 79.9 s of it (its 8,192 PutSets 56.4 s at 34.7 ms
              # of host encryption a row; H100 80GB HBM3, 700 W); half the
              # rows halve that and decrypt_rows' read-back (one chunk)
              "client.ops_per_client": "2048 -> 1024 PutSets a client",
              # the next full run took 1,239.9 s on a slower host, chaos 309.8
              # s of it: the restarted proxy's first SumAll over its 2,064
              # cold tags answered 503 36 times in 254.2 s (ROADMAP §C 5;
              # 4.7-23.4 s in PR 19's runs); half the rows halve that tag round,
              # the load and the read-back
              "chaos.K": "2048 -> 1024 rows"}


def earlier_config():
    """DDSConfig() with EARLIER_OBS_CUTS applied."""
    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig()
    cfg.obs.audit_enabled = EARLIER_OBS_CUTS["obs.audit_enabled"]
    cfg.obs.slo_route = EARLIER_OBS_CUTS["obs.slo_route"]
    return cfg


def reset_counts() -> None:
    from dds_tpu_torch.ops import mont_cuda

    for c in mont_cuda.LAUNCHES.values():
        c.reset()


def read_counts(dev) -> dict:
    from dds_tpu_torch.ops import mont_cuda

    sync(dev)
    return {k: c.value for k, c in mont_cuda.LAUNCHES.items()}


def paillier_rows(pk, K: int, seed: int, n_blinds: int = 64) -> tuple[list, int]:
    """K PutSet rows of bft_sum's shape, the PSSE column (position 2) the
    encryptions of 1..K under `n_blinds` seeded obfuscators; and the
    plaintext total."""
    rng = np.random.default_rng(seed)
    blinds = [pk.blind(int.from_bytes(rng.bytes(pk.n.bit_length() // 8 - 1), "little"))
              for _ in range(min(n_blinds, K))]
    rows = [[i, f"name-{i}", pk.encrypt(i + 1, rn=blinds[i % len(blinds)]),
             2, "a", "b", "c", "blob"] for i in range(K)]
    return rows, K * (K + 1) // 2


async def put_rows(port: int, rows: list, inflight: int = 64) -> float:
    """PutSet every row (`inflight` at a time); returns the seconds it
    took."""
    from dds_tpu_torch.http.miniserver import http_request

    sem = asyncio.Semaphore(inflight)

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


async def audited_round(dev, sizes, dep, sumall, result: int, plain: dict) -> dict:
    """The mode-0 rounds again on the e2e stack with the audit and /slo on
    (the Watchtower reset, configured for the stack and attached to the
    tracer; the SLO engine observes every request either way): the
    Watchtower's cost on the request path beside the rounds without it
    (`plain`), with its stats, which must show audited ops and no
    violation. Counts are zeroed before and read after (path
    "sumall_audited")."""
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.utils.trace import tracer

    cfg = dep.cfg
    reset_counts()  # this round's run starts here
    watchtower.reset()
    watchtower.configure(quorum_size=cfg.replicas.byz_quorum_size,
                         n_replicas=len(cfg.replicas.endpoints), check_quorum=True)
    watchtower.attach(tracer)
    dep.server.cfg.slo_route_enabled = True
    try:
        seq = []
        for _ in range(sizes["requests"]):
            t = time.perf_counter()
            if await sumall() != result:
                raise AssertionError("audited SumAll changed")
            seq.append(time.perf_counter() - t)
        t = time.perf_counter()
        for _ in range(sizes["rounds"]):
            if any(g != result for g in await asyncio.gather(*(sumall() for _ in range(8)))):
                raise AssertionError("audited concurrent SumAll changed")
        per_req = (time.perf_counter() - t) / (sizes["rounds"] * 8)
        status, body = await http_request("127.0.0.1", dep.server.cfg.port, "GET", "/slo")
        await dep.net.quiesce()
        stats = watchtower.stats()
    finally:
        watchtower.detach()
        dep.server.cfg.slo_route_enabled = False
    counts = check_mode_launches(dev, read_counts(dev), "0", "audited SumAll")
    if status != 200 or "SumAll" not in json.loads(body)["slo"]["routes"]:
        raise AssertionError(f"audited round: /slo answered {status}")
    if stats["ops_audited"] <= 0 or stats["violations"]:
        raise AssertionError(f"audited round: Watchtower {stats}")
    return {"sumall_ms_seq": min(seq) * 1e3, "sumall_ms_seq_median": statistics.median(seq) * 1e3,
            "sumall_ms_concurrent": per_req * 1e3,
            "plain_sumall_ms_seq": plain["sumall_ms_seq"],
            "plain_sumall_ms_seq_median": plain["sumall_ms_seq_median"],
            "plain_sumall_ms_concurrent": plain["sumall_ms_concurrent"],
            "median_over_plain": statistics.median(seq) * 1e3 / plain["sumall_ms_seq_median"],
            "concurrent_over_plain": per_req * 1e3 / plain["sumall_ms_concurrent"],
            "sumalls": sizes["requests"] + 8 * sizes["rounds"],
            "launches": counts["mont_mul"], "watchtower": stats}


async def phase_e2e(dev, sizes) -> dict:
    """The SumAll path at K rows: mode 0 (cold SumAll, then sequential and
    concurrency-8 rounds), then the same rounds on the same stack under
    DDS_KARATSUBA=1 and =2. Counts are zeroed before and read after each
    mode; each mode must launch its own fold kernels and no others."""
    import os

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K = sizes["K_path"]
    t = time.perf_counter()
    rows, total = paillier_rows(pk, K, 11)
    gen_s = time.perf_counter() - t

    cfg = earlier_config()
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
        os.environ["DDS_KARATSUBA"] = "0"
        audited = await audited_round(dev, sizes, dep, sumall, result, modes["0"])
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
        "obs_cuts": EARLIER_OBS_CUTS,
        "audited": audited,
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
    folds and launch mont_mul; then the same burst with the window off.
    Then the "adaptive" round: the same rows (loaded 8 in flight) and
    bursts on a stack with `[admission]` and `adaptive-coalesce` on, the
    window sized from the observed fold arrival rate (base 2 ms, cap
    20 ms, 8 folds a pass), the bursts once the shed ratchet is at 0:
    every SumAll exact, every burst with a `fold_many` pass of two or more
    folds on B1, and every drain's window within [base, cap]."""
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K, C = sizes["K_coalesce"], sizes["coalesce_burst"]
    rows, total = paillier_rows(pk, K, 12)
    settle: dict = {}

    async def stack(adaptive: bool):
        cfg = earlier_config()
        cfg.proxy.device = dev.type
        cfg.proxy.min_device_batch = sizes["coalesce_min_batch"]  # None: the measured 256
        cfg.admission.enabled = adaptive
        cfg.admission.adaptive_coalesce = adaptive
        dep = await launch(cfg)
        server = dep.server
        if K >= server.backend.min_device_batch:
            await dep.stop()
            raise AssertionError(f"K={K} is not below "
                                 f"min_device_batch={server.backend.min_device_batch}")
        # with admission on, a loader within the PutSet objective (250 ms)
        await put_rows(server.cfg.port, rows, 8 if adaptive else 64)
        sumall = sumall_fn(server.cfg.port, pk.nsquare)
        if key.decrypt(await sumall()) != total:  # cold: fills the tag cache
            await dep.stop()
            raise AssertionError("coalesce-phase SumAll does not decrypt to the total")
        if adaptive:
            # a cold SumAll past the default 250 ms objective is, alone in
            # its windows, a 100 % burn: the bursts wait for the ratchet
            # to be back at 0, as a client honouring Retry-After would
            t = time.perf_counter()
            while server.admission.shed_level and time.perf_counter() - t < 30.0:
                await asyncio.sleep(0.1)
            settle["s"] = time.perf_counter() - t
            settle["transitions"] = list(server.admission.transitions)
        return dep, sumall

    async def burst(sumall) -> list[float]:
        async def timed() -> tuple[int, float]:
            t = time.perf_counter()
            r = await sumall()
            return r, time.perf_counter() - t

        got = await asyncio.gather(*(timed() for _ in range(C)))
        for r, _ in got:
            if key.decrypt(r) != total:
                raise AssertionError("coalesced SumAll does not decrypt to the total")
        return [dt for _, dt in got]

    dep, sumall = await stack(False)
    try:
        server = dep.server
        window = server.cfg.coalesce_window
        min_batch = server.backend.min_device_batch
        reset_counts()  # the coalesced path's run starts here
        tracer.reset()
        lat = []
        for _ in range(sizes["coalesce_rounds"]):
            lat += await burst(sumall)
        counts = read_counts(dev)
        spans = tracer.summary()
        groups = [e.meta["R"] for e in tracer.events("kernel.foldmany.execute")]
        multi = [r for r in groups if r >= 2]
        if not multi:
            raise AssertionError(f"no fold_many pass carried 2 or more folds: {groups}")
        if dev.type == "cuda" and counts["mont_mul"] <= 0:
            raise AssertionError("the coalesced fold never launched mont_mul")
        server.cfg.coalesce_window = 0.0
        lat_off = await burst(sumall)
    finally:
        await dep.stop()

    # the adaptive round: each burst's passes and launches read apart
    dep, sumall = await stack(True)
    try:
        server = dep.server
        coalescer = server._coalescer
        windows: list[float] = []
        real_window = server._coalesce_window

        def recorded() -> float:  # each drain's window, as the drainer reads it
            windows.append(real_window())
            return windows[-1]

        server._coalesce_window = recorded
        bursts = []
        reset_counts()  # the adaptive coalesced path's run starts here
        launches = 0
        for _ in range(sizes["coalesce_rounds"]):
            tracer.reset()
            before = read_counts(dev)["mont_mul"]
            lat_a = await burst(sumall)
            passes = [e.meta["R"] for e in tracer.events("kernel.foldmany.execute")]
            launched = read_counts(dev)["mont_mul"] - before
            if not any(r >= 2 for r in passes):
                raise AssertionError(f"adaptive burst: no fold_many pass of 2 or more "
                                     f"folds: {passes}")
            if dev.type == "cuda" and launched <= 0:
                raise AssertionError("adaptive burst: the coalesced fold never launched B1")
            launches += launched
            bursts.append({"folds_per_pass": passes, "mont_mul_launches": launched,
                           "request_ms_mean": statistics.mean(lat_a) * 1e3,
                           "request_ms_median": statistics.median(lat_a) * 1e3})
        lo, hi = coalescer.base_window, coalescer.max_window
        if not windows or not all(lo <= w <= hi for w in windows):
            raise AssertionError(f"adaptive windows outside [{lo}, {hi}]: {windows}")
        adaptive = {"base_window_s": lo, "max_window_s": hi,
                    "target_folds": coalescer.target_folds, "drain_windows_ms": [
                        w * 1e3 for w in windows], "bursts": bursts,
                    "mont_mul_launches": launches, "coalescer": coalescer.stats(),
                    "settle": settle,
                    "request_ms_median": statistics.median(
                        [b["request_ms_median"] for b in bursts])}
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
        "adaptive": adaptive,
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

    cfg = earlier_config()
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
    scan with the tag-validated cache off) over one of its four cases."""
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
    # one of search_latency.py's four cases (gt): each cache-less query
    # takes 14-17 s on the card at this size, the same for all four
    base = [r for r in after if r[0] == "SearchGt"]
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
    --ops 200`; `mixed_preload` rows and `mixed_ops` a client: 1,024 and 25
    on the card, MIXED_CUT) through the port:
    7 replicas, quorum 5 (f = 2, the
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
        cfg = earlier_config()
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
    The REST level runs in the sharded phase, on configs/sharded.toml as
    it stands (DEPTH_CUTS)."""
    import os

    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.models.backend import CudaBackend
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.parallel.mesh import combine_partials, mesh_fold, mesh_fold_launches

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
                    dev_ms, dispatch_ms = held_ms(lambda: mesh_fold(ctx, [slabs], dev, flag), 3, dev)
                    cell["modes"][mode] = {
                        "cold_ms": min(cold_ms), "warm_ms": min(warm_ms),
                        "cold_over_warm": min(cold_ms) / min(warm_ms),
                        "fused_device_ms": dev_ms, "fused_dispatch_ms": dispatch_ms,
                        "launches_per_fold": {k: v // reps for k, v in counts.items() if v},
                    }
                predicted = mesh_fold_launches([[len(g) for _, g in parts]])
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
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
    emit("resident", what="summary", **{k: v for k, v in rec.items() if k != "cells"})
    return rec


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
    Stratum run in mode 0 and of one fold in modes 1 and 2. The REST level
    runs in the sharded phase, on configs/stratum.toml as it stands
    (DEPTH_CUTS)."""
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
    finally:
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
    emit("tiered", **rec)
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

    from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models._symmetric import aes_available
    from dds_tpu_torch.models.facade import DEFAULT_SCHEMA
    from dds_tpu_torch.run import launch, load_provider
    from dds_tpu_torch.utils.trace import tracer

    C, ops = sizes["clients"], sizes["ops_per_client"]
    cfg = earlier_config()
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
    cfg = earlier_config()
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


# ---------------------------------------------------------------- recovery

# the phase's budget on the card (seconds); reported beside its wall time
RECOVERY_BUDGET_S = 150.0
# default.toml's edge planes, turned off here (printed) so the phase's
# numbers compare with its runs before they were ported; the bulwark phase
# runs the file with them
RECOVERY_CUTS = {"admission.enabled": False, "obs.audit_enabled": False,
                 "obs.slo_route": False}


def recovery_config(dev, sizes, flight_dir: str, snapshot_dir: str = ""):
    """configs/default.toml with its [replicas] and [recovery] unchanged
    (timers times `recovery_scale`, 1 on the card; anti-entropy at the
    reference's default, on), the cuts above, the `cuda` backend on `dev`
    folding every SumAll on the device, /metrics on, the flight recorder
    in `flight_dir`, Trudy armed, snapshots restored from
    `snapshot_dir`."""
    import pathlib

    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.load(pathlib.Path(__file__).resolve().parent / "configs" / "default.toml")
    s = sizes["recovery_scale"]
    for name in ("warm_up", "interval", "sentinent_awake_timeout",
                 "crashed_recovery_timeout", "manifest_timeout",
                 "anti_entropy_interval", "anti_entropy_jitter"):
        setattr(cfg.recovery, name, getattr(cfg.recovery, name) * s)
    for name in ("intranet_request_timeout", "request_budget"):
        setattr(cfg.proxy, name, getattr(cfg.proxy, name) * s)
    cfg.admission.enabled = RECOVERY_CUTS["admission.enabled"]
    cfg.obs.audit_enabled = RECOVERY_CUTS["obs.audit_enabled"]
    cfg.obs.slo_route = RECOVERY_CUTS["obs.slo_route"]
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.device = dev.type
    cfg.proxy.min_device_batch = 0
    cfg.obs.metrics_route = True
    cfg.obs.flight_dir = flight_dir
    cfg.attacks.enabled = True
    cfg.recovery.snapshot_dir = snapshot_dir
    return cfg


class RecoveryRun:
    """One deployment of the recovery phase: every operation logged with
    its interval and outcome, every recovery with its trigger kind, wall
    time (trigger to `wait_recovery_idle`) and the StateChunk frames and
    bytes it shipped, the fault windows the phase announces, and every
    SumAll checked: exact, and folded on B1 on the card."""

    def __init__(self, dep, dev, sizes, key, expected: int):
        self.dep, self.dev, self.sizes, self.key = dep, dev, sizes, key
        self.expected = expected
        self.ops: list[dict] = []
        self.recoveries: list[dict] = []
        self.inflight: list[dict] = []
        self.windows: list[dict] = []
        self.port = dep.server.cfg.port
        # the proxy's membership refresh keeps its ratio to the recovery
        # timers (the loop reads it from its second round on; launch has
        # not yielded since it started the loop)
        dep.server.cfg.replica_refresh_interval *= sizes["recovery_scale"]
        self._wrap()

    def _wrap(self) -> None:
        from dds_tpu_torch.core import messages as M

        sup, net = self.dep.supervisor, self.dep.net
        recover, send = sup.recover, net.send

        async def tracked(victim: str):
            name = getattr(asyncio.current_task(), "get_name", lambda: "")()
            # the proactive timer's task, a Suspect's delivery, or the phase
            kind = ("proactive" if name.startswith("supervisor.recover") else
                    "suspicion" if name.startswith("inmem.deliver") else "operator")
            rec = {"victim": victim, "kind": kind, "t0": time.perf_counter(),
                   "chunks": 0, "bytes": 0, "keys": 0,
                   # the supervisor refuses one already in flight or not active
                   "noop": victim in sup._recovering or victim not in self.active()}
            self.inflight.append(rec)
            try:
                await recover(victim)
            finally:
                await sup.wait_recovery_idle(60.0)
                rec["t1"] = time.perf_counter()
                rec["swapped"] = not rec["noop"] and victim not in self.active()
                self.inflight.remove(rec)
                if not rec["noop"]:
                    self.recoveries.append(rec)

        def counted(src: str, dest: str, msg) -> None:
            if src == sup.addr and isinstance(msg, (M.StateChunk, M.SleepBegin, M.Sleep)):
                payload = msg.digests if isinstance(msg, M.SleepBegin) else (
                    msg.entries if isinstance(msg, M.StateChunk) else msg.data)
                size = len(json.dumps(payload, separators=(",", ":")))
                for rec in self.inflight:
                    if rec["victim"] == dest:
                        rec["bytes"] += size
                        if not isinstance(msg, M.SleepBegin):
                            rec["chunks"] += 1
                            rec["keys"] += len(payload)
            send(src, dest, msg)

        sup.recover = tracked
        net.send = counted

    def _log(self, kind: str, t0: float, ok: bool, detail: str = "") -> None:
        self.ops.append({"kind": kind, "t0": t0, "t1": time.perf_counter(), "ok": ok,
                         "detail": detail})

    async def call(self, method: str, target: str, body: bytes | None = None):
        from dds_tpu_torch.http.miniserver import http_request

        return await http_request("127.0.0.1", self.port, method, target, body,
                                  timeout=300.0)

    async def read_back(self, acked: dict, sem) -> dict:
        """GetSet every acknowledged key (64 in flight): each must answer
        the row written."""
        t = time.perf_counter()
        mismatched = []

        async def get(k, r):
            async with sem:
                t0 = time.perf_counter()
                status, body = await self.call("GET", f"/GetSet/{k}")
                self._log("GetSet", t0, status == 200, str(status))
                if status == 200 and json.loads(body)["contents"] != r:
                    mismatched.append(k)

        await asyncio.gather(*(get(k, r) for k, r in acked.items()))
        if mismatched:
            raise AssertionError(f"recovery: {len(mismatched)} acknowledged PutSets "
                                 "read back different")
        return {"keys": len(acked), "s": time.perf_counter() - t}

    async def sumall(self) -> None:
        """One SumAll: a 200 must decrypt to the total, equal the Python-int
        fold and (on the card) have launched B1; a failure is logged."""
        from dds_tpu_torch.ops import mont_cuda

        before = mont_cuda.LAUNCHES["mont_mul"].value
        t0 = time.perf_counter()
        status, body = await self.call("GET", f"/SumAll?position={PSSE_POS}"
                                              f"&nsqr={self.key.public.nsquare}")
        if status != 200:
            self._log("SumAll", t0, False, f"{status} {body[:120]!r}")
            return
        result = int(json.loads(body)["result"])
        if result != self.expected or self.key.decrypt(result) != self.sizes["recovery_total"]:
            raise AssertionError("recovery: SumAll is not the exact fold of the stored rows")
        if self.dev.type == "cuda" and mont_cuda.LAUNCHES["mont_mul"].value == before:
            raise AssertionError("recovery: a SumAll did not fold on B1 (mont_mul)")
        self._log("SumAll", t0, True)

    async def sumalls_until(self, done, cap_s: float, what: str) -> float:
        """SumAlls back to back until `done()`; fails past `cap_s`."""
        t0 = time.perf_counter()
        while not done():
            if time.perf_counter() - t0 > cap_s:
                raise AssertionError(f"recovery: {what} not reached in {cap_s:.0f} s")
            await self.sumall()
        return time.perf_counter() - t0

    def active(self) -> list[str]:
        return [a for a, _ in self.dep.supervisor.active]

    def idle(self) -> bool:
        return not self.inflight and self.dep.supervisor._idle.is_set()

    def completed(self, since: float, victim: str | None = None,
                  kind: str | None = None) -> list[dict]:
        return [r for r in self.recoveries if r["t0"] >= since and r["swapped"]
                and (victim is None or r["victim"] == victim)
                and (kind is None or r["kind"] == kind)]

    def open_window(self, name: str) -> dict:
        w = {"name": name, "t0": time.perf_counter()}
        self.windows.append(w)
        return w

    def latency(self) -> dict:
        """SumAll ms with and without a recovery in flight (overlapping
        the request), p50 and p95."""
        spans = [(r["t0"], r.get("t1", math.inf)) for r in self.recoveries + self.inflight]
        out = {"with_recovery": [], "without_recovery": []}
        for op in self.ops:
            if op["kind"] == "SumAll" and op["ok"]:
                hit = any(a < op["t1"] and op["t0"] < b for a, b in spans)
                out["with_recovery" if hit else "without_recovery"].append(
                    (op["t1"] - op["t0"]) * 1e3)
        return {k: {"count": len(v),
                    "p50_ms": float(np.percentile(v, 50)) if v else None,
                    "p95_ms": float(np.percentile(v, 95)) if v else None}
                for k, v in out.items()}

    def failures(self) -> dict:
        """Failed operations inside the announced fault windows (each
        window's own count) and outside them; every one is listed."""
        inside, outside = collections.Counter(), []
        for op in self.ops:
            if op["ok"]:
                continue
            w = next((w for w in self.windows
                      if w["t0"] <= op["t0"] <= w.get("t1", math.inf)), None)
            if w is None:
                outside.append(op)
            else:
                inside[w["name"]] += 1
        return {"in_windows": dict(inside), "outside": len(outside),
                "listed": [{k: op[k] for k in ("kind", "detail")}
                           | {"at_s": op["t0"]} for op in self.ops if not op["ok"]]}


async def recovery_probe(run: RecoveryRun, families: tuple) -> dict:
    """GET /health (200 with a `recovery` section) and /metrics (carrying
    `families`)."""
    status, body = await run.call("GET", "/health")
    health = json.loads(body)
    if status != 200 or "recovery" not in health:
        raise AssertionError(f"recovery: /health answered {status} {sorted(health)}")
    status, body = await run.call("GET", "/metrics")
    text = body.decode()
    missing = [f for f in families if f not in text]
    if status != 200 or missing:
        raise AssertionError(f"recovery: /metrics {status} lacks {missing}")
    return {"health_status": health["status"], "active_replicas": health["active_replicas"],
            "reachable_replicas": health["reachable_replicas"],
            "recovery_replicas": len(health["recovery"]),
            "families": {f: sum(1 for ln in text.splitlines() if ln.startswith(f))
                         for f in families}}


async def phase_recovery(dev, sizes) -> dict:
    """The SumAll path under the dependability plane (configs/default.toml's
    9 endpoints, 2 sentinent spares, quorum 5, f = 2, warm-up 5 s, interval
    7 s, verified transfer, 256-key chunks): K Paillier rows by quorum
    PutSet; SumAlls through at least 2 proactive recoveries; Trudy turns
    f = 2 active replicas byzantine; Trudy crashes the replica the
    proactive timer takes next and the supervisor redeploys it; the active
    replicas holding each acknowledged row counted; save_all of the 9
    replicas and one more
    generation of replica-0 with a bit flipped; a second deployment
    restores them at launch (the flipped file quarantined,
    the older generation loaded), a SumAll over the restored state, an
    in-sync and a repairing anti-entropy round, a promoted stale spare
    converging; /health and /metrics on both. Every SumAll exact and on
    B1; 0 failed operations outside the announced fault windows. The
    acknowledged PutSets are read back once, through the restored
    deployment: the faults' state saved and loaded."""
    import os
    import random
    import tempfile

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.core import snapshot as snap
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    s = sizes["recovery_scale"]
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K = sizes["recovery_K"]
    rows, total = paillier_rows(pk, K, 13, n_blinds=8)
    sizes = {**sizes, "recovery_total": total}
    expected = host_product([r[PSSE_POS] for r in rows], pk.nsquare)
    metrics.reset()
    tracer.reset()
    saved = os.environ.get("DDS_KARATSUBA")
    os.environ["DDS_KARATSUBA"] = "0"
    tmp = tempfile.TemporaryDirectory(prefix="dds_recovery_")
    flight_dir, snap_dir = f"{tmp.name}/flight", f"{tmp.name}/snapshots"
    rec: dict = {"K": K, "key_bits": sizes["key_bits"], "replicas": 9, "spares": 2,
                 "quorum": 5, "f": 2, "cuts": RECOVERY_CUTS, "timer_scale": s}

    def step(name: str, **kw) -> None:  # progress, so a failed run still shows its steps
        emit("recovery_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    try:
        reset_counts()  # path "recovery" starts here
        cfg = recovery_config(dev, sizes, flight_dir)
        rec["timers_s"] = {"warm_up": cfg.recovery.warm_up, "interval": cfg.recovery.interval,
                           "sentinent_awake_timeout": cfg.recovery.sentinent_awake_timeout,
                           "crashed_recovery_timeout": cfg.recovery.crashed_recovery_timeout}
        dep = await launch(cfg)
        run = RecoveryRun(dep, dev, sizes, key, expected)
        try:
            # -- load: K quorum PutSets, 64 in flight
            sem = asyncio.Semaphore(64)
            acked: dict[str, list] = {}

            async def put(r):
                async with sem:
                    t0 = time.perf_counter()
                    status, body = await run.call("POST", "/PutSet",
                                                  json.dumps({"contents": r}).encode())
                    run._log("PutSet", t0, status == 200, str(status))
                    if status == 200:
                        acked[body.decode()] = r

            t = time.perf_counter()
            await asyncio.gather(*(put(r) for r in rows))
            rec["load"] = {"s": time.perf_counter() - t, "acked": len(acked),
                           "recoveries_during": len(run.completed(0.0))}
            step("load", **rec["load"])
            # -- 1: SumAlls through two proactive recoveries
            t1 = time.perf_counter()
            await run.sumalls_until(lambda: len(run.completed(t1, kind="proactive")) >= 2,
                                    max(45.0 * s, 12.0), "2 proactive recoveries")
            rec["proactive_s"] = time.perf_counter() - t1
            # the span ring's recent window (replica spans crowd it out)
            rec["spans_ms"] = {n: {k: v[k] for k in ("count", "mean_ms", "p95_ms")}
                               for n, v in tracer.summary().items()
                               if n in ("http.GET.SumAll", "proxy.fetch_stored",
                                        "abd.read_tags", "abd.fetch", "proxy.fold",
                                        "supervisor.recover", "antientropy.sync")}
            step("proactive", s=rec["proactive_s"], sumall=run.latency(),
                 spans_ms=rec["spans_ms"])
            # -- 2: Trudy turns f = 2 active replicas byzantine (sent with no
            # round in flight: a replica compromised mid-round answers its
            # late replies with forged writes, which spares store)
            await dep.net.quiesce()
            dep.trudy.replicas = run.active()
            dep.trudy._rng = random.Random(sizes["recovery_seed"])
            byz = run.open_window("byzantine")
            byz["victims"] = dep.trudy.trigger("byzantine")
            # each victim recovered since the attack (a recovered one may be
            # promoted again later, honest, as a spare)
            await run.sumalls_until(
                lambda: all(run.completed(byz["t0"], v) for v in byz["victims"])
                and run.idle(), max(90.0 * s, 15.0), "recovery of the byzantine replicas")
            byz["t1"] = time.perf_counter()
            byz["recovered_by"] = {v: [r["kind"] for r in run.completed(byz["t0"], v)]
                                   for v in byz["victims"]}
            step("byzantine", s=byz["t1"] - byz["t0"], victims=byz["victims"],
                 recovered_by=byz["recovered_by"], failures=run.failures()["in_windows"])
            # -- 3: Trudy crashes the replica the proactive timer takes next
            oldest = min(dep.supervisor.active, key=lambda r: r[1])[0]
            old_node = dep.replicas[oldest]
            dep.trudy.replicas, dep.trudy.max_faults = [oldest], 1
            crash = run.open_window("crash")
            crash["victims"] = dep.trudy.trigger("crash")
            await run.sumalls_until(
                lambda: bool(run.completed(crash["t0"], oldest)) and run.idle(),
                max(60.0 * s, 15.0), "the crashed replica's redeploy")
            crash["t1"] = time.perf_counter()
            crash["recovered_by"] = {oldest: [r["kind"] for r in run.completed(crash["t0"],
                                                                               oldest)]}
            if dep.replicas[oldest] is old_node or not dep.net.has_endpoint(oldest):
                raise AssertionError("recovery: the crashed replica was not redeployed")
            crash["redeployed"] = True
            step("crash", s=crash["t1"] - crash["t0"], victims=crash["victims"],
                 failures=run.failures()["in_windows"])
            # -- 4: where the faults left every acknowledged PutSet: the
            # active replicas holding its row (read back through the proxy
            # from the snapshots of this state below)
            await dep.supervisor.wait_recovery_idle(60.0)
            await dep.net.quiesce()
            holders = [sum(1 for a in run.active()
                           if (dep.replicas[a].repository.get(k) or (None, None))[1] == r)
                       for k, r in acked.items()]
            rec["census"] = {"keys": len(acked), "min_active_holders": min(holders),
                             "keys_below_quorum": sum(h < 5 for h in holders)}
            step("census", **rec["census"])
            rec["probe_first"] = await recovery_probe(
                run, ("dds_suspect_votes_total", "dds_trusted_replicas",
                      "dds_replica_suspicion", "dds_breaker_state"))
            rec["suspicion_quorums"] = sum(
                v for k, v in (metrics._families.get("dds_suspicion_quorums_total").samples
                               if metrics._families.get("dds_suspicion_quorums_total")
                               else {}).items())
            # -- 5: save_all, then a second generation of replica-0, flipped
            secret = snap.derive_secret(cfg.security.abd_mac_secret.encode())
            t = time.perf_counter()
            snap.save_all(dep.replicas, snap_dir, secret=secret,
                          keep=cfg.recovery.snapshot_keep)
            save_ms = (time.perf_counter() - t) * 1e3
            files = sorted(os.listdir(snap_dir))
            nbytes = sum(os.path.getsize(f"{snap_dir}/{f}") for f in files)
            p2 = snap.save_replica(dep.replicas["replica-0"], snap_dir, secret=secret)
            raw = bytearray(p2.read_bytes())
            raw[len(raw) // 2] ^= 0x01
            p2.write_bytes(bytes(raw))
            first = run
            step("snapshot_save", save_all_ms=save_ms, bytes=nbytes)
        finally:
            await dep.stop()
        # -- 6: a fresh deployment restores the snapshots
        cfg2 = recovery_config(dev, sizes, flight_dir, snap_dir)
        # without the proactive timer: the anti-entropy step below names
        # the spares and the replica it recovers, so membership holds still
        cfg2.recovery.enabled = False
        t = time.perf_counter()
        dep2 = await launch(cfg2)
        boot_ms = (time.perf_counter() - t) * 1e3
        run2 = RecoveryRun(dep2, dev, sizes, key, expected)
        try:
            gens = {n: r.snapshot_meta.get("generation") for n, r in dep2.replicas.items()}
            corrupt = sorted(f for f in os.listdir(snap_dir) if f.endswith(".corrupt"))
            if gens != {n: 1 for n in dep2.replicas} or corrupt != [
                    "replica-0.snapshot.00000002.corrupt"]:
                raise AssertionError(f"recovery: snapshot restore {gens} {corrupt}")
            rec["snapshot"] = {
                "save_all_ms": save_ms, "bytes": nbytes, "files": len(files),
                "restore_boot_ms": boot_ms, "generations_loaded": gens,
                "quarantined": corrupt,
                "verify_failures": metrics.value("dds_snapshot_verify_failures_total",
                                                 replica="replica-0")}
            for k in acked:  # the harness hands the proxy its aggregate keys
                dep2.server._note_stored(k)
            # every acknowledged PutSet read back through quorum reads of the
            # restored replicas, the state the faults left (this also fills
            # the new proxy's tag cache: a cold SumAll's 8,192 concurrent
            # quorum reads outlast its budget)
            rec["read_back"] = await run2.read_back(acked, sem)
            step("read_back", **rec["read_back"])
            t = time.perf_counter()
            await run2.sumall()
            if not run2.ops[-1]["ok"]:
                raise AssertionError(f"recovery: SumAll over the restored state failed "
                                     f"{run2.ops[-1]['detail']}")
            rec["snapshot"]["sumall_after_restore_ms"] = (time.perf_counter() - t) * 1e3
            step("restore", **{k: v for k, v in rec["snapshot"].items()
                               if k != "generations_loaded"})
            # -- anti-entropy: one in-sync round between two active replicas
            act = run2.active()
            a, b = next(((x, y) for x in act for y in act if x < y
                         and dep2.replicas[x].merkle.root() == dep2.replicas[y].merkle.root()),
                        (act[0], act[1]))
            t = time.perf_counter()
            n_sync = await dep2.replicas[a].antientropy.sync_once(b)
            ae = {"in_sync_round_ms": (time.perf_counter() - t) * 1e3, "in_sync_repaired": n_sync,
                  "pair": [a, b]}
            # a stale spare promoted: both spares lose their state, the
            # oldest active is recovered, the seeder is stale either way
            for sp in dep2.supervisor.sentinent:
                dep2.replicas[sp]._install_repository({})
            oldest = min(dep2.supervisor.active, key=lambda r: r[1])[0]
            t_rec = time.perf_counter()
            await dep2.supervisor.recover(oldest)
            promoted = [x for x in run2.active() if x not in act][0]
            healthy = dep2.replicas[b]
            # one repairing round, timed: the reseeded (empty) offender pulls
            t = time.perf_counter()
            n_rep = await dep2.replicas[oldest].antientropy.sync_once(b)
            ae.update({"repair_round_ms": (time.perf_counter() - t) * 1e3,
                       "repair_round_keys": n_rep, "tracked_keys": len(healthy.merkle),
                       "promoted_stale_spare": promoted})
            await run2.sumalls_until(
                lambda: dep2.replicas[promoted].merkle.root() == healthy.merkle.root(),
                max(40.0 * s, 15.0), "anti-entropy convergence of the promoted spare")
            ae["promoted_converged_s"] = time.perf_counter() - t_rec
            ae["loop_repaired_keys"] = dep2.replicas[promoted].antientropy.repaired_total
            rec["antientropy"] = ae
            step("antientropy", **ae)
            rec["probe_second"] = await recovery_probe(
                run2, ("dds_antientropy_rounds_total", "dds_antientropy_repaired_keys_total",
                       "dds_antientropy_divergent_buckets", "dds_snapshot_generation",
                       "dds_snapshot_verify_failures_total", "dds_suspect_votes_total"))
        finally:
            await dep2.stop()
        counts = read_counts(dev)
        rec["launches"] = counts["mont_mul"]  # read just after the path's run
        if dev.type == "cuda" and rec["launches"] <= 0:
            raise AssertionError("recovery: B1 never launched")
        fails = first.failures()
        fails2 = run2.failures()
        if fails["outside"] or fails2["outside"] + sum(fails2["in_windows"].values()):
            raise AssertionError(f"recovery: failed operations outside the fault windows: "
                                 f"{fails} {fails2}")
        recs = first.recoveries + run2.recoveries
        rec.update({
            "sumall": first.latency(),
            "sumalls": sum(1 for r in (first, run2) for o in r.ops if o["kind"] == "SumAll"),
            "recoveries": [{"victim": r["victim"], "kind": r["kind"], "swapped": r["swapped"],
                            "chunks": r["chunks"], "keys": r["keys"], "bytes": r["bytes"],
                            "wall_s": r["t1"] - r["t0"]} for r in recs],
            "windows": [{"name": w["name"], "victims": w.get("victims"),
                         "s": w["t1"] - w["t0"], "recovered_by": w.get("recovered_by")}
                        for w in first.windows],
            "failures": fails,
            "flight_incidents": len([f for f in os.listdir(flight_dir)
                                     if f.startswith("incident-")])
            if os.path.isdir(flight_dir) else 0,
        })
    finally:
        tmp.cleanup()
        if saved is None:
            os.environ.pop("DDS_KARATSUBA", None)
        else:
            os.environ["DDS_KARATSUBA"] = saved
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = RECOVERY_BUDGET_S
    emit("recovery", **{k: rec[k] for k in ("K", "seconds", "launches", "sumalls",
                                            "suspicion_quorums", "failures")})
    return rec


# ----------------------------------------------------------------- bulwark

# the phase's budget on the card (seconds); reported beside its wall time
BULWARK_BUDGET_S = 150.0
# default.toml's settings the phase overrides (printed); everything else
# stands as the file says
BULWARK_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the file's cpu is the reference's host backend)",
    "data": "bench_paillier_key(2048): Paillier-2048, n^2 of L = 256 (the file's "
            "[client] paillier-bits = 512 sizes a generated client, not this data)",
}


def bulwark_config(dev):
    """configs/default.toml as it stands (9 endpoints, 2 spares, quorum 5,
    f = 2, recovery and anti-entropy on with the file's timers,
    [admission] on with its buckets, ratchet and adaptive window, the
    audit with quorum checks, /slo with its per-route objectives, Trudy
    off) with the `cuda` backend on `dev` at the port's min_device_batch."""
    import pathlib

    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.load(pathlib.Path(__file__).resolve().parent / "configs" / "default.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.device = dev.type
    return cfg


def family(name: str) -> dict:
    """{labels dict as a sorted tuple: value} of one metrics family."""
    from dds_tpu_torch.obs.metrics import metrics

    fam = metrics._families.get(name)
    return dict(fam.samples) if fam is not None else {}


def admission_census() -> dict:
    """dds_admission_requests_total summed by outcome."""
    out = collections.Counter()
    for labels, v in family("dds_admission_requests_total").items():
        out[dict(labels)["outcome"]] += v
    return dict(out)


def pct(xs: list, q: float):
    return float(np.percentile(xs, q)) if xs else None


async def phase_bulwark(dev, sizes) -> dict:
    """configs/default.toml served on the card with Bulwark, the SLO engine
    and the Watchtower as the file arms them (BULWARK_OVERRIDES printed):
    K Paillier rows by quorum PutSet through the admitted edge (a 429 is
    honoured by its Retry-After and counted); steady SumAlls, the first
    warming the tag cache; one burst of background-class requests past
    that class's bucket; then benchmarks/overload_goodput.py's open-loop
    schedule without ChaosNet, its clients on their own loop in a thread:
    interactive GetSets of stored keys and a SumAll flood for
    `bulwark_flood_s` seconds (seed `bulwark_seed`), with /health, /metrics
    and /slo probed each second; then a quiet tail of single SumAlls.
    Gates: every SumAll answering 200 equals the Python-int fold of the
    stored ciphertexts (which decrypts to the total), B1 launched on the
    path (each steady SumAll on its own); every GetSet answering 200
    returns its row; every rejection a 429 or 503 with Retry-After >= 1
    and the admission body, a 429 past the background burst, SumAlls of
    the flood refused, and the requests issued equal to those the
    controller admitted plus those it rejected; the probes 200 and /slo
    parsing; the Watchtower attached, auditing ops, with no violation; no
    500."""
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.http.miniserver import http_request_full
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    K = sizes["bulwark_K"]
    rows, total = paillier_rows(pk, K, 14, n_blinds=8)
    expected = host_product([r[PSSE_POS] for r in rows], pk.nsquare)
    if key.decrypt(expected) != total:
        raise AssertionError("bulwark: the Python-int fold does not decrypt to the total")
    sumall_target = f"/SumAll?position={PSSE_POS}&nsqr={pk.nsquare}"
    metrics.reset()
    tracer.reset()
    cfg = bulwark_config(dev)
    rec: dict = {"K": K, "key_bits": sizes["key_bits"], "replicas": 9, "spares": 2,
                 "quorum": 5, "overrides": BULWARK_OVERRIDES,
                 "admission": {k: getattr(cfg.admission, k) for k in (
                     "interactive_rate", "interactive_burst", "aggregate_rate",
                     "aggregate_burst", "background_rate", "background_burst",
                     "eval_interval", "shed_hold", "max_shed_level", "fast_fail",
                     "adaptive_coalesce", "coalesce_max_window", "coalesce_target_folds")},
                 "coalesce_window": cfg.proxy.coalesce_window,
                 "audit": [cfg.obs.audit_enabled, cfg.obs.audit_quorum_checks],
                 "slo_routes": cfg.obs.slo_routes, "min_device_batch": cfg.proxy.min_device_batch}
    emit("bulwark_step", step="config", **rec)
    issued = collections.Counter()  # requests sent to admission-gated routes, by route
    answers: list[dict] = []        # every answer of the phase

    def step(name: str, **kw) -> None:
        emit("bulwark_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    def check_rejection(route: str, status: int, headers: dict, body: bytes) -> None:
        if not body.startswith(b"admission rejected (") or int(headers.get(
                "retry-after", 0)) < 1:
            raise AssertionError(f"bulwark: a {route} {status} is not an admission "
                                 f"rejection with Retry-After >= 1: {headers} {body[:120]!r}")

    async def call(route: str, method: str, target: str, body: bytes | None = None,
                   where: str = "") -> tuple[int, dict, bytes]:
        issued[route] += 1
        t0 = time.perf_counter()
        status, headers, data = await http_request_full("127.0.0.1", port, method, target,
                                                        body, timeout=600.0)
        kind = "ok" if status == 200 else (
            "rejected" if data.startswith(b"admission rejected (") else
            "degraded" if status == 503 else "other")
        answers.append({"route": route, "status": status, "kind": kind, "where": where,
                        "t0": t0, "ms": (time.perf_counter() - t0) * 1e3})
        if status == 500 or kind == "other":
            raise AssertionError(f"bulwark: {route} answered {status} {data[:160]!r}")
        if kind == "rejected":
            check_rejection(route, status, headers, data)
        elif kind == "degraded" and int(headers.get("retry-after", 0)) < 1:
            raise AssertionError(f"bulwark: a degraded {route} 503 without Retry-After")
        return status, headers, data

    def exact(data: bytes) -> None:
        if int(json.loads(data)["result"]) != expected:
            raise AssertionError("bulwark: a SumAll is not the exact fold of the stored rows")

    reset_counts()  # path "bulwark" starts here
    dep = await launch(cfg)
    server = dep.server
    port = server.cfg.port
    transitions: list[dict] = []
    server.admission.subscribe(lambda r: transitions.append(
        {"at_s": time.perf_counter() - t_phase, **{k: r[k] for k in ("from", "to", "reason")}}))
    try:
        if not watchtower.attached:
            raise AssertionError("bulwark: the Watchtower is not attached")
        # -- load: K quorum PutSets, `bulwark_load_inflight` in flight (a
        # loader within the file's PutSet objective, 250 ms; 64 in flight
        # queue ~360 ms each on this stack, burn that objective and shed
        # the aggregates for the windows' length), honouring each 429
        sem = asyncio.Semaphore(sizes["bulwark_load_inflight"])
        keys: dict[str, list] = {}
        waits = {"429": 0, "retry_after_s": 0}

        async def put(r):
            async with sem:
                body = json.dumps({"contents": r}).encode()
                while True:
                    status, headers, data = await call("PutSet", "POST", "/PutSet", body,
                                                       "load")
                    if status == 200:
                        keys[data.decode()] = r
                        return
                    if status == 429:
                        waits["429"] += 1
                        waits["retry_after_s"] += int(headers["retry-after"])
                    # a 429, or a shed or degraded 503: back after Retry-After
                    await asyncio.sleep(int(headers["retry-after"]))

        t = time.perf_counter()
        await asyncio.gather(*(put(r) for r in rows))
        rec["load"] = {"s": time.perf_counter() - t, "rows": len(keys), **waits,
                       "putsets_per_s": K / (time.perf_counter() - t),
                       "inflight": sizes["bulwark_load_inflight"],
                       "shed_level": server.admission.shed_level,
                       "transitions": list(transitions)}
        if len(keys) != K:
            raise AssertionError(f"bulwark: {len(keys)} of {K} PutSets acknowledged")
        step("load", **rec["load"])
        # -- steady SumAlls, the first warming the tag cache; each on B1
        steady = []
        for _ in range(sizes["requests"]):
            before = mont_cuda.LAUNCHES["mont_mul"].value
            t = time.perf_counter()
            status, headers, data = await call("SumAll", "GET", sumall_target, where="steady")
            if status != 200:
                raise AssertionError(f"bulwark: a steady SumAll answered {status}")
            exact(data)
            steady.append((time.perf_counter() - t) * 1e3)
            if dev.type == "cuda" and mont_cuda.LAUNCHES["mont_mul"].value == before:
                raise AssertionError("bulwark: a steady SumAll did not fold on B1")
        rec["steady_ms"] = {"cold": steady[0], "warm_median": statistics.median(steady[1:]),
                            "warm": steady[1:]}
        step("steady", **rec["steady_ms"])
        # -- settle: a cold SumAll past its 1 s objective is, alone in its
        # windows, a 100 % burn, and an evaluation in that instant sheds
        # background; the phase goes on once the ratchet is back at 0
        t = time.perf_counter()
        while server.admission.shed_level and time.perf_counter() - t < 30.0:
            await asyncio.sleep(0.1)
        rec["settle"] = {"s": time.perf_counter() - t, "shed_level": server.admission.shed_level,
                         "transitions": list(transitions)}
        step("settle", **rec["settle"])
        if server.admission.shed_level:
            raise AssertionError(f"bulwark: the ratchet did not return to 0 before the "
                                 f"throttle burst: {server.admission.report()}")
        # -- the throttle path at the file's settings, on an idle loop: one
        # burst of background-class requests (a route the port does not
        # serve, 404 once admitted) past the class's burst of 32; each
        # one over it answers 429 with its refill ETA
        n_burst = int(cfg.admission.background_burst) + 16
        burst = await asyncio.gather(*(http_request_full(
            "127.0.0.1", port, "GET", "/_sync", timeout=600.0) for _ in range(n_burst)))
        for status, headers, data in burst:
            if status == 429:
                check_rejection("_sync", status, headers, data)
            elif status != 404:
                raise AssertionError(f"bulwark: a background request answered {status} "
                                     f"{data[:120]!r}: {server.admission.report()}")
        rec["throttle"] = {"sent": n_burst,
                           "admitted_404": sum(1 for st, _, _ in burst if st == 404),
                           "throttled_429": sum(1 for st, _, _ in burst if st == 429),
                           "retry_after": sorted({h["retry-after"] for st, h, _ in burst
                                                  if st == 429})}
        step("throttle", **rec["throttle"])
        if not rec["throttle"]["throttled_429"]:
            raise AssertionError(f"bulwark: no 429 past the background burst {rec['throttle']}")
        # -- the overload window: the open-loop schedule, then its drain
        tracer.reset(max_events=1 << 20)
        census0 = admission_census()
        issued0 = sum(issued.values())
        sched_rng = random.Random(sizes["bulwark_seed"] + 1)
        dur = sizes["bulwark_flood_s"]

        def arrivals(rate: float) -> list[float]:
            out, t = [], 0.0
            while t < dur:
                out.append(t)
                t += sched_rng.uniform(0.5, 1.5) / rate
            return out

        stored = sorted(keys)
        schedule = sorted([("GetSet", t) for t in arrivals(sizes["bulwark_interactive_rate"])]
                          + [("SumAll", t) for t in arrivals(sizes["bulwark_aggregate_rate"])],
                          key=lambda a: a[1])
        picks = [stored[sched_rng.randrange(len(stored))] for _ in schedule]
        probes: list[dict] = []

        async def fire(route: str, k: str) -> None:
            if route == "GetSet":
                status, _, data = await call("GetSet", "GET", f"/GetSet/{k}", where="flood")
                if status == 200 and json.loads(data)["contents"] != keys[k]:
                    raise AssertionError("bulwark: a GetSet returned another row")
            else:
                status, _, data = await call("SumAll", "GET", sumall_target, where="flood")
                if status == 200:
                    exact(data)

        async def probe_loop() -> None:
            while True:
                for route in ("health", "metrics", "slo"):
                    t0 = time.perf_counter()
                    status, _, data = await http_request_full("127.0.0.1", port, "GET",
                                                              f"/{route}", timeout=600.0)
                    if status != 200:
                        raise AssertionError(f"bulwark: /{route} answered {status} "
                                             "during the flood")
                    if route == "slo":
                        json.loads(data)
                    probes.append({"route": route, "ms": (time.perf_counter() - t0) * 1e3})
                await asyncio.sleep(1.0)

        async def drive() -> tuple[float, float]:
            """The schedule, open loop: each arrival fires at its time
            whatever the answers before it do; then its drain."""
            prober = asyncio.ensure_future(probe_loop())
            t0 = time.perf_counter()
            pending = []
            for (route, at), k in zip(schedule, picks):
                delay = at - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                pending.append(asyncio.ensure_future(fire(route, k)))
            fired = time.perf_counter() - t0
            try:
                await asyncio.gather(*pending)
            finally:
                prober.cancel()
                await asyncio.gather(prober, return_exceptions=True)
            return fired, time.perf_counter() - t0

        # the clients run on an event loop of their own, in a thread, as
        # users on other hosts would: on the server's loop the schedule
        # would wait for the server's work and stop being open loop
        with concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="flood") as pool:
            fired_s, drained_s = await asyncio.get_running_loop().run_in_executor(
                pool, lambda: asyncio.run(drive()))
        flood = [a for a in answers if a["where"] == "flood"]
        by_route = {r: dict(collections.Counter(a["status"] for a in flood if a["route"] == r))
                    for r in ("GetSet", "SumAll")}
        good_ms = server.slo.slo_for("GetSet").latency_ms
        rec["flood"] = {
            "seconds": dur, "fired_s": fired_s, "drained_s": drained_s,
            "scheduled": dict(collections.Counter(r for r, _ in schedule)),
            "status_by_route": by_route,
            "interactive_goodput_per_s": sum(
                1 for a in flood if a["route"] == "GetSet" and a["status"] == 200
                and a["ms"] <= good_ms) / drained_s,
            "good_latency_ms": good_ms,
            "ms_by_route_kind": {f"{r}.{k}": {"count": len(v), "p50": pct(v, 50),
                                              "p99": pct(v, 99)}
                                 for r in ("GetSet", "SumAll")
                                 for k in ("ok", "rejected", "degraded")
                                 for v in [[a["ms"] for a in flood
                                            if a["route"] == r and a["kind"] == k]]},
            "probes": {r: {"count": len(v), "max_ms": max(v) if v else None}
                       for r in ("health", "metrics", "slo")
                       for v in [[p["ms"] for p in probes if p["route"] == r]]},
        }
        rec["flood"]["rejected_by_route"] = {r: dict(collections.Counter(
            a["status"] for a in flood if a["route"] == r and a["kind"] == "rejected"))
            for r in ("GetSet", "SumAll")}
        rec["flood"]["transitions"] = list(transitions)
        step("flood", **rec["flood"])
        # the flood's excess is refused at the edge: throttled (429) while
        # the class's bucket is dry, shed (503) once the ratchet sheds
        # aggregates, whichever comes first at the loop's pace
        if not rec["flood"]["rejected_by_route"]["SumAll"]:
            raise AssertionError(f"bulwark: no SumAll of the flood was refused: {by_route}")
        if not all(rec["flood"]["probes"][r]["count"] for r in ("health", "metrics", "slo")):
            raise AssertionError("bulwark: a probe route never answered during the flood")
        # -- the quiet tail: single SumAlls, one at a time
        t = time.perf_counter()
        tail = collections.Counter()
        while time.perf_counter() - t < sizes["bulwark_tail_s"]:
            status, headers, data = await call("SumAll", "GET", sumall_target, where="tail")
            tail[status] += 1
            if status == 200:
                exact(data)
            else:
                await asyncio.sleep(min(int(headers["retry-after"]), 1))
        rec["tail"] = {"status": dict(tail), "s": time.perf_counter() - t,
                       "shed_level_end": server.admission.shed_level}
        step("tail", **rec["tail"])
        # -- the admission ledger against the client's count
        census1 = admission_census()
        window_issued = sum(issued.values()) - issued0
        admitted = census1.get("admitted", 0) - census0.get("admitted", 0)
        rejected_server = sum(census1.get(o, 0) - census0.get(o, 0)
                              for o in ("throttled", "shed", "tenant_shed"))
        late = [a for a in answers if a["where"] in ("flood", "tail")]
        rejected_client = sum(1 for a in late if a["kind"] == "rejected")
        if window_issued != admitted + rejected_client or rejected_client != rejected_server:
            raise AssertionError(f"bulwark: issued {window_issued} != admitted {admitted} + "
                                 f"rejected {rejected_client} (server {rejected_server})")
        spans = [e.dur_ms * 1e3 for e in tracer.events("proxy.admission")]
        audit = watchtower.stats()
        if not audit["attached"] or audit["ops_audited"] <= 0 or audit["violations"]:
            raise AssertionError(f"bulwark: Watchtower {audit}")
        degraded = collections.Counter()
        for labels, v in family("dds_degraded_total").items():
            d = dict(labels)
            degraded[f"{d['route']}.{d['kind']}"] += v
        _, _, slo_body = await http_request_full("127.0.0.1", port, "GET", "/slo")
        slo = json.loads(slo_body)
        rec.update({
            "admission_ledger": {"issued": window_issued, "admitted": admitted,
                                 "rejected": rejected_client, "by_outcome": {
                                     o: census1.get(o, 0) - census0.get(o, 0)
                                     for o in set(census1) | set(census0)}},
            "statuses_by_route": {r: dict(collections.Counter(
                a["status"] for a in answers if a["route"] == r))
                for r in ("PutSet", "GetSet", "SumAll")},
            "transitions": transitions,
            "admission_span_us": {"count": len(spans), "p50": pct(spans, 50),
                                  "p99": pct(spans, 99)},
            "degraded_503_by_kind": dict(degraded),
            "coalescer": server._coalescer.stats() if server._coalescer is not None else None,
            "watchtower": audit,
            "slo_burns": server.slo.burns(),
            "slo_alerts": server.slo.alerts(),
            "slo_route_totals": {r: v["windows"][f"{int(slo['slo']['windows_s'][0])}s"][
                "total"] for r, v in slo["slo"]["routes"].items()},
            "recovery_spans": len(tracer.events("supervisor.recover")),
        })
    finally:
        await dep.stop()
    counts = read_counts(dev)
    rec["launches"] = counts["mont_mul"]  # read just after the path's run
    if dev.type == "cuda" and rec["launches"] <= 0:
        raise AssertionError("bulwark: B1 never launched")
    if watchtower.attached:
        raise AssertionError("bulwark: stop left the Watchtower attached")
    rec["sumalls_ok"] = sum(1 for a in answers if a["route"] == "SumAll" and a["status"] == 200)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = BULWARK_BUDGET_S
    emit("bulwark", **{k: rec[k] for k in (
        "K", "seconds", "budget_s", "launches", "sumalls_ok", "admission_ledger",
        "statuses_by_route", "transitions", "admission_span_us", "degraded_503_by_kind",
        "coalescer", "watchtower", "slo_burns")})
    return rec


TENANCY_BUDGET_S = 150.0
TENANCY_VICTIMS = ("gold", "tenant-00", "tenant-01", "batch-etl")  # Zipf rank order
TENANCY_FLOODER = "flood"
TENANCY_SHED_WAIT_S = 120.0  # the most one must-serve SumAll waits for an open class
TENANCY_CANARY = "__heliograph__"
# configs/tenancy.toml's settings the phase overrides (printed); everything
# else stands as the file says
TENANCY_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the file names none: the reference's default is its "
                            "cpu host backend)",
    "proxy.port": "0 (an OS-assigned port for the file's 8080)",
    "data": "each tenant's own key family from TenantKeyring(paillier_bits, rsa_bits) at the "
            "file's [tenancy] 2048 and 1024 bits; seeded plaintexts blinded on the card (B3, "
            "one pow_mod a tenant); one column a record",
}


def tenancy_config(dev):
    """configs/tenancy.toml as it stands (4 replicas, quorum 3, f = 1,
    [tenancy] on with gold 3.0 and batch-etl 0.5, [admission] on with
    interactive 400/800 and aggregate 64/128, /slo, the audit at its
    default, on) with the `cuda` backend on `dev` and an OS-assigned
    port."""
    import pathlib

    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.load(pathlib.Path(__file__).resolve().parent / "configs" / "tenancy.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.device = dev.type
    cfg.proxy.port = 0
    return cfg


def zipf_weights(n: int, s: float) -> list[float]:
    """benchmarks/tenant_isolation.py's rank weights 1 / r^s."""
    w = [1.0 / r ** s for r in range(1, n + 1)]
    return [x / sum(w) for x in w]


async def phase_tenancy(dev, sizes) -> dict:
    """configs/tenancy.toml served on the card (TENANCY_OVERRIDES printed):
    four victim tenants and a flooder, each with its own key family from a
    `TenantKeyring` at the file's bits, so each folds under its own n^2.
    Each tenant's rows blinded on the card (B3) and written by PutSet under
    its header, 8 in flight; one SumAll a victim, then the four at once,
    each the Python fold of exactly that tenant's rows under its n^2 and
    decrypting to its total, on B1; the isolation gates (a typed 403 for a
    cross-tenant GetSet and for another tenant's content replayed by
    PutSet, a SumAll under another tenant's n^2 folding only the caller's
    rows, the canary's rows scoped to the canary, /health's owned keys,
    /metrics' per-tenant series, /slo's tenants, Chronoscope's usage
    ledger); the reference's shred drill mid-traffic; then
    benchmarks/tenant_isolation.py's noisy neighbour at the file's rates,
    its clients on their own loop (run A victims only, run B with the
    flooder's SumAlls from 2 s before the victim window). Gates: every 200
    SumAll exact, every refusal a 429 or 503 with Retry-After >= 1, no
    victim GetSet 429, no 500, the shredded tenant's keys refused and its
    rows served, 0 Watchtower violations. A SumAll the phase must have
    served waits, without a request, for the aggregate class to be open
    (`aggregate_open`); the noisy runs' requests are open loop."""
    from dds_tpu_torch.http.miniserver import http_request_full
    from dds_tpu_torch.models.backend import get_backend
    from dds_tpu_torch.models.tenancy import TenantKeyring, TenantShredded
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    cfg = tenancy_config(dev)
    tenants = TENANCY_VICTIMS + (TENANCY_FLOODER,)
    n_rows = {t: sizes["tenancy_rows"] for t in TENANCY_VICTIMS}
    n_rows[TENANCY_FLOODER] = sizes["tenancy_flood_rows"]
    bits = (sizes["tenancy_paillier_bits"], sizes["tenancy_rsa_bits"])
    rec: dict = {"tenants": list(tenants), "rows": n_rows, "bits": bits,
                 "overrides": TENANCY_OVERRIDES, "replicas": len(cfg.replicas.endpoints),
                 "quorum": cfg.replicas.byz_quorum_size,
                 "weights": dict(cfg.tenancy.weights),
                 "admission": {k: getattr(cfg.admission, k) for k in (
                     "interactive_rate", "interactive_burst", "aggregate_rate",
                     "aggregate_burst", "eval_interval", "max_shed_level")},
                 "audit": cfg.obs.audit_enabled, "slo_route": cfg.obs.slo_route}

    def step(name: str, **kw) -> None:
        emit("tenancy_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    step("config", **rec)
    # -- keys: one family a tenant, generated on first touch
    kr = TenantKeyring(paillier_bits=bits[0], rsa_bits=bits[1],
                       grace=cfg.tenancy.rotation_grace)
    t = time.perf_counter()
    for tn in tenants:
        kr.keys_for(tn)
    rec["keygen_s"] = time.perf_counter() - t
    nsq = {tn: kr.keys_for(tn).psse.nsquare for tn in tenants}
    if len(set(nsq.values())) != len(tenants):
        raise AssertionError("tenancy: two tenants share a Paillier modulus")
    step("keys", keygen_s=rec["keygen_s"])
    rng = random.Random(sizes["tenancy_seed"])
    plain = {tn: [rng.randrange(1 << 30) for _ in range(n_rows[tn])] for tn in tenants}
    metrics.reset()
    tracer.reset()
    chronoscope_was = chronoscope.enabled
    chronoscope.enabled = True  # the earlier phases ran with it off (the "cuts" line)
    answers: list[dict] = []

    async def req(method: str, target: str, tenant: str | None, obj=None,
                  where: str = "") -> tuple[int, dict, bytes]:
        t0 = time.perf_counter()
        status, headers, data = await http_request_full(
            "127.0.0.1", port, method, target,
            json.dumps(obj).encode() if obj is not None else None,
            headers={"x-dds-tenant": tenant} if tenant else None, timeout=600.0)
        answers.append({"where": where, "tenant": tenant, "status": status,
                        "ms": (time.perf_counter() - t0) * 1e3})
        if status == 500:
            raise AssertionError(f"tenancy: {method} {target[:40]} by {tenant} answered 500")
        return status, headers, data

    def fold_of(tn: str, modulus: int | None = None) -> int:
        return host_product([c for _, c in stored[tn]], modulus or nsq[tn])

    reset_counts()  # path "tenancy" starts here
    dep = await launch(cfg)
    server = dep.server
    port = server.cfg.port
    transitions: list[dict] = []
    server.admission.subscribe(lambda r: transitions.append(
        {"at_s": time.perf_counter() - t_phase, **{k: r[k] for k in ("from", "to", "reason")}}))
    shed_wait = collections.Counter()  # seconds a must-serve SumAll waited for the class
    client_be = get_backend("cuda", device=dev.type)  # the clients' own blinding backend
    stored: dict[str, list[tuple[str, int]]] = {tn: [] for tn in tenants}
    try:
        if not watchtower.attached or not chronoscope.stats()["attached"]:
            raise AssertionError("tenancy: launch left the Watchtower or Chronoscope detached")
        # -- blinding on the card: one B3 pow_mod a tenant
        t = time.perf_counter()
        cts = {tn: kr.keys_for(tn).psse.public.encrypt_batch(plain[tn], client_be, min_batch=1)
               for tn in tenants}
        sync(dev)
        rec["encrypt_s"] = time.perf_counter() - t
        # -- load: every tenant's rows by PutSet under its header, 8 in flight
        order = [(tn, c) for tn in tenants for c in cts[tn]]
        random.Random(sizes["tenancy_seed"] + 1).shuffle(order)
        sem = asyncio.Semaphore(sizes["tenancy_load_inflight"])
        waits = collections.Counter()

        async def put(tn: str, c: int) -> None:
            async with sem:
                while True:
                    status, headers, data = await req("POST", "/PutSet", tn,
                                                      {"contents": [str(c)]}, "load")
                    if status == 200:
                        stored[tn].append((data.decode(), c))
                        return
                    if status not in (429, 503) or int(headers.get("retry-after", 0)) < 1:
                        raise AssertionError(f"tenancy: a PutSet answered {status} {data[:120]!r}")
                    waits[str(status)] += 1
                    await asyncio.sleep(int(headers["retry-after"]))

        t = time.perf_counter()
        await asyncio.gather(*(put(tn, c) for tn, c in order))
        load_s = time.perf_counter() - t
        rec["load"] = {"s": load_s, "rows": len(order), "putsets_per_s": len(order) / load_s,
                       "encrypt_s": rec["encrypt_s"], "waits": dict(waits),
                       "inflight": sizes["tenancy_load_inflight"]}
        step("load", **rec["load"])
        # -- per-tenant folds: one SumAll a victim, then the four at once
        async def aggregate_open(where: str) -> None:
            """Wait, without a request, until the aggregate class is not
            shed. A shed SumAll's 503 burns the route's objective again, so
            clients retrying on Retry-After keep the class shed for the SLO
            window (300 s in full run 2); the server's own view of the
            ratchet is read instead, as the bulwark phase's settle does."""
            t0 = time.perf_counter()
            while "aggregate" in server.admission.report()["shedding"]:
                if time.perf_counter() - t0 > TENANCY_SHED_WAIT_S:
                    raise AssertionError(f"tenancy: the aggregate class stayed shed "
                                         f"{TENANCY_SHED_WAIT_S:.0f} s ({where})")
                await asyncio.sleep(0.05)
            shed_wait[where] += time.perf_counter() - t0

        async def sumall(tn: str, where: str, modulus: int | None = None) -> tuple[int, float]:
            """One SumAll that must be served: sent once the aggregate class
            is open; a refusal (429, or a shed or degraded 503, each with
            Retry-After) is counted in `waits` and sent again, after its
            Retry-After for a 429 or a degraded 503."""
            while True:
                await aggregate_open(where)
                t0 = time.perf_counter()
                status, headers, data = await req(
                    "GET", f"/SumAll?position=0&nsqr={modulus or nsq[tn]}", tn, where=where)
                if status == 200:
                    return int(json.loads(data)["result"]), (time.perf_counter() - t0) * 1e3
                if status not in (429, 503) or int(headers.get("retry-after", 0)) < 1:
                    raise AssertionError(f"tenancy: {tn}'s {where} SumAll answered {status}")
                waits[f"{where}.{status}"] += 1
                if not data.startswith(b"admission rejected (shed"):
                    await asyncio.sleep(int(headers["retry-after"]))

        def check(tn: str, result: int) -> None:
            if result != fold_of(tn) or kr.decrypt(tn, result) != sum(plain[tn]):
                raise AssertionError(f"tenancy: {tn}'s SumAll is not the fold of its own rows")

        folds = {}
        for tn in TENANCY_VICTIMS:
            before = mont_cuda.LAUNCHES["mont_mul"].value
            result, ms = await sumall(tn, "fold")
            check(tn, result)
            folds[tn] = {"ms": ms, "launches": mont_cuda.LAUNCHES["mont_mul"].value - before}
        before = mont_cuda.LAUNCHES["mont_mul"].value
        t = time.perf_counter()
        together = await asyncio.gather(*(sumall(tn, "fold") for tn in TENANCY_VICTIMS))
        for tn, (result, _) in zip(TENANCY_VICTIMS, together):
            check(tn, result)
        rec["folds"] = {"each": folds, "together_ms": (time.perf_counter() - t) * 1e3,
                        "together_ms_each": [ms for _, ms in together],
                        "together_launches": mont_cuda.LAUNCHES["mont_mul"].value - before,
                        "K": n_rows[TENANCY_VICTIMS[0]]}
        if dev.type == "cuda" and any(f["launches"] <= 0 for f in folds.values()):
            raise AssertionError(f"tenancy: a victim's SumAll did not fold on B1: {folds}")
        step("folds", **rec["folds"])
        # -- isolation gates
        gold, other = TENANCY_VICTIMS[0], TENANCY_VICTIMS[1]
        k0, c0 = stored[gold][0]
        status, _, data = await req("GET", f"/GetSet/{k0}", other, where="gate")
        denied = json.loads(data) if status == 403 else None
        if denied != {"error": "cross-tenant access denied", "tenant": other, "key": k0}:
            raise AssertionError(f"tenancy: a cross-tenant GetSet answered {status} {data[:160]!r}")
        status, _, data = await req("POST", "/PutSet", TENANCY_VICTIMS[2],
                                    {"contents": [str(c0)]}, "gate")
        if status != 403 or json.loads(data)["key"] != k0:
            raise AssertionError(f"tenancy: a cross-tenant PutSet replay answered {status}")
        result, _ = await sumall(other, "gate", nsq[gold])
        if result != fold_of(other, nsq[gold]):
            raise AssertionError("tenancy: a SumAll under another tenant's n^2 left its rows")
        gpk = kr.keys_for(gold).psse.public
        canary_plain = [rng.randrange(1 << 30) for _ in range(2)]
        canary = [gpk.encrypt(m) for m in canary_plain]
        for c in canary:
            status, _, _ = await req("POST", "/PutSet", TENANCY_CANARY, {"contents": [str(c)]},
                                     "gate")
            if status != 200:
                raise AssertionError(f"tenancy: a canary PutSet answered {status}")
        status, _, data = await req("GET", f"/SumAll?position=0&nsqr={nsq[gold]}",
                                    TENANCY_CANARY, where="gate")
        canary_fold = int(json.loads(data)["result"])
        if canary_fold != host_product(canary, nsq[gold]) or \
                kr.decrypt(gold, canary_fold) != sum(canary_plain):
            raise AssertionError("tenancy: the canary's SumAll is not the fold of its own rows")
        result, _ = await sumall(gold, "gate")
        check(gold, result)
        _, _, health = await req("GET", "/health", None, where="gate")
        owned = json.loads(health)["tenants"]
        _, _, text = await req("GET", "/metrics", None, where="gate")
        series = {tn: metrics.value("dds_tenant_stored_keys", tenant=tn) for tn in tenants}
        _, _, slo = await req("GET", "/slo", None, where="gate")
        slo_tenants = sorted(json.loads(slo)["slo"].get("tenants", {}))
        usage = chronoscope.tenant_usage()
        rec["gates"] = {"owned_keys": owned["owned_keys"], "shed": owned["shed"],
                        "stored_keys_series": series, "slo_tenants": slo_tenants,
                        "usage": {tn: usage.get(tn) for tn in tenants},
                        "canary_rows": len(canary)}
        step("gates", **rec["gates"])
        if owned["owned_keys"] != sum(n_rows.values()) + len(canary):
            raise AssertionError(f"tenancy: /health owns {owned['owned_keys']} keys")
        if series != {tn: n_rows[tn] for tn in tenants} or b"dds_tenant_stored_keys" not in text:
            raise AssertionError(f"tenancy: dds_tenant_stored_keys {series}")
        if not set(tenants) <= set(slo_tenants) or not set(tenants) <= set(usage):
            raise AssertionError(f"tenancy: /slo tenants {slo_tenants}, usage {sorted(usage)}")
        # -- the shred drill mid-traffic, before the noisy runs: after the
        # flood the GetSet route's burn holds the aggregate class shed for
        # the 300 s SLO window (full run 2), so no SumAll would be served
        victim = TENANCY_VICTIMS[2]
        survivors = [tn for tn in TENANCY_VICTIMS if tn != victim]
        stop = asyncio.Event()
        reads = collections.Counter()

        async def traffic(tn: str) -> None:
            i = 0
            while not stop.is_set():
                k, c = stored[tn][i % n_rows[tn]]
                status, _, data = await req("GET", f"/GetSet/{k}", tn, where="drill")
                if status != 200 or json.loads(data)["contents"] != [str(c)]:
                    raise AssertionError(f"tenancy: {tn}'s drill read answered {status}")
                reads[tn] += 1
                if i % 8 == 7 and tn != victim:
                    check(tn, (await sumall(tn, "drill"))[0])
                i += 1

        movers = [asyncio.ensure_future(traffic(tn)) for tn in TENANCY_VICTIMS]
        t = time.perf_counter()
        try:
            await asyncio.sleep(0.2)
            version = await asyncio.to_thread(kr.rotate, victim)
            k1, c1 = stored[victim][0]
            c_new, v_new, migrated = await asyncio.to_thread(kr.reencrypt, victim, c1, 1)
            m1 = dict(zip(cts[victim], plain[victim]))[c1]
            if (version, v_new, migrated) != (2, 2, True) or \
                    kr.decrypt(victim, c_new, v_new) != m1:
                raise AssertionError("tenancy: re-encrypt-on-read did not move a row to epoch 2")
            await asyncio.sleep(0.2)
            summary = kr.shred(victim)
            await asyncio.sleep(0.2)
        finally:
            stop.set()
            await asyncio.gather(*movers)
        drill_s = time.perf_counter() - t
        for tn in survivors:
            check(tn, (await sumall(tn, "drill"))[0])
        status, _, data = await req("GET", f"/GetSet/{stored[victim][1][0]}", victim, where="drill")
        served = status == 200 and json.loads(data)["contents"] == [str(stored[victim][1][1])]
        shredded_fold, _ = await sumall(victim, "drill")  # n^2 kept from before the shred
        refused = []
        for attempt in (lambda: kr.decrypt(victim, c1, 1), lambda: kr.decrypt(victim, c_new, 2),
                        lambda: kr.encrypt(victim, 1), lambda: kr.keys_for(victim),
                        lambda: kr.hmac_secret(victim)):
            try:
                attempt()
                refused.append(False)
            except TenantShredded:
                refused.append(True)
        audit = watchtower.stats()
        rec["drill"] = {"s": drill_s, "reads": dict(reads), "summary": summary,
                        "served_ciphertext": served,
                        "served_fold_exact": shredded_fold == fold_of(victim),
                        "refused": refused, "watchtower": audit,
                        "keyring": {tn: kr.stats()["domains"][tn] for tn in tenants}}
        step("drill", **rec["drill"])
        if not (served and rec["drill"]["served_fold_exact"] and all(refused)):
            raise AssertionError(f"tenancy: the shred drill {rec['drill']}")
        if summary["epochs_scrubbed"] != 2 or not all(reads[tn] for tn in TENANCY_VICTIMS):
            raise AssertionError(f"tenancy: the shred drill {rec['drill']}")
        if not audit["attached"] or audit["ops_audited"] <= 0 or audit["violations"]:
            raise AssertionError(f"tenancy: Watchtower {audit}")
        # -- settle: the noisy runs should start with no class shed, but
        # SumAlls past the file's 250 ms objective (cold folds, the four at
        # once) can keep the aggregate class shed for the 300 s window, and
        # a shed SumAll's 503 burns it again: wait at most 10 s, then go on
        # and print the level the runs start at
        t = time.perf_counter()
        while server.admission.shed_level and time.perf_counter() - t < 10.0:
            await asyncio.sleep(0.1)
        rec["settle"] = {"s": time.perf_counter() - t, "shed_level": server.admission.shed_level,
                         "waits": dict(waits)}
        step("settle", **rec["settle"])
        # -- the noisy neighbour: one seeded Zipf schedule, without and with the flood
        weights = zipf_weights(len(TENANCY_VICTIMS), sizes["tenancy_zipf_s"])
        window = sizes["tenancy_window_s"]
        rows_of = {tn: dict(stored[tn]) for tn in tenants}
        expected = {tn: fold_of(tn) for tn in tenants}

        def schedule(seed: int) -> list[tuple[str, str, float, str]]:
            srng = random.Random(seed)
            out, at = [], 0.0
            while at < window:
                tn = srng.choices(TENANCY_VICTIMS, weights=weights)[0]
                op = "SumAll" if srng.random() < sizes["tenancy_agg_frac"] else "GetSet"
                out.append((tn, op, at, stored[tn][srng.randrange(n_rows[tn])][0]))
                at += srng.uniform(0.5, 1.5) / sizes["tenancy_interactive_rate"]
            return out

        async def drive(flood: bool) -> tuple[list, list]:
            victims, flooder = [], []

            async def fire(tn: str, op: str, k: str, out: list) -> None:
                target = (f"/GetSet/{k}" if op == "GetSet"
                          else f"/SumAll?position=0&nsqr={nsq[tn]}")
                t0 = time.perf_counter()
                status, headers, data = await http_request_full(
                    "127.0.0.1", port, "GET", target, headers={"x-dds-tenant": tn},
                    timeout=600.0)
                out.append({"tenant": tn, "op": op, "status": status,
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "retry_after": int(headers.get("retry-after", 0)),
                            "admission": data.startswith(b"admission rejected ("),
                            "ok": status != 200 or (
                                json.loads(data)["contents"] == [str(rows_of[tn][k])]
                                if op == "GetSet" else
                                int(json.loads(data)["result"]) == expected[tn])})

            async def open_loop(arrivals, out: list) -> None:
                t0, pending = time.perf_counter(), []
                for tn, op, at, k in arrivals:
                    delay = at - (time.perf_counter() - t0)
                    if delay > 0:
                        await asyncio.sleep(delay)
                    pending.append(asyncio.ensure_future(fire(tn, op, k, out)))
                await asyncio.gather(*pending)

            flood_task = None
            if flood:
                frng = random.Random(sizes["tenancy_seed"] + 99)
                farr, at = [], 0.0
                while at < window + sizes["tenancy_lead_s"]:
                    farr.append((TENANCY_FLOODER, "SumAll", at, ""))
                    at += frng.uniform(0.5, 1.5) / sizes["tenancy_flood_rate"]
                flood_task = asyncio.ensure_future(open_loop(farr, flooder))
                await asyncio.sleep(sizes["tenancy_lead_s"])
            await open_loop(schedule(sizes["tenancy_seed"] + 2), victims)
            if flood_task is not None:
                await flood_task
            return victims, flooder

        runs = {}
        for label, flood in (("A", False), ("B", True)):
            shed_seen: set = set()

            async def watch_shed() -> None:
                while True:
                    shed_seen.update(server.admission.shed_tenants())
                    await asyncio.sleep(0.25)

            watcher = asyncio.ensure_future(watch_shed())
            t = time.perf_counter()
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        1, thread_name_prefix="tenants") as pool:
                    victims, flooder = await asyncio.get_running_loop().run_in_executor(
                        pool, lambda: asyncio.run(drive(flood)))
            finally:
                watcher.cancel()
                await asyncio.gather(watcher, return_exceptions=True)
            shed_seen.update(server.admission.shed_tenants())
            bad = [a for a in victims + flooder if a["status"] == 500 or not a["ok"] or (
                a["status"] not in (200, 429, 503)) or (
                a["status"] in (429, 503) and a["retry_after"] < 1)]
            if bad:
                raise AssertionError(f"tenancy: run {label} answers out of contract: {bad[:5]}")
            if any(a["op"] == "GetSet" and a["status"] == 429 for a in victims):
                raise AssertionError(f"tenancy: a victim GetSet was throttled in run {label}")
            lat = [a["ms"] for a in victims if a["op"] == "GetSet" and a["status"] == 200]
            runs[label] = {
                "s": time.perf_counter() - t, "victim_requests": len(victims),
                "victim_getset_p50_ms": pct(lat, 50), "victim_getset_p95_ms": pct(lat, 95),
                "victim_status": {f"{op}.{s}": n for (op, s), n in collections.Counter(
                    (a["op"], a["status"]) for a in victims).items()},
                "victim_sumall_p50_ms": pct([a["ms"] for a in victims if a["op"] == "SumAll"
                                             and a["status"] == 200], 50),
                "flooder_status": dict(collections.Counter(a["status"] for a in flooder)),
                "flooder_refused_admission": sum(1 for a in flooder if a["admission"]),
                "flooder_ok_p50_ms": pct([a["ms"] for a in flooder if a["status"] == 200], 50),
                "shed_tenants_seen": sorted(shed_seen), "flood_shed": TENANCY_FLOODER in shed_seen,
                "sumalls_exact": sum(1 for a in victims + flooder
                                     if a["op"] == "SumAll" and a["status"] == 200),
            }
            step(f"noisy_{label}", **runs[label])
        a95, b95 = runs["A"]["victim_getset_p95_ms"], runs["B"]["victim_getset_p95_ms"]
        rec["noisy"] = {**runs, "p95_ratio": (b95 / a95) if a95 and b95 else None,
                        "bar": 1.10, "window_s": window, "lead_s": sizes["tenancy_lead_s"],
                        "interactive_rate": sizes["tenancy_interactive_rate"],
                        "flood_rate": sizes["tenancy_flood_rate"],
                        "zipf_s": sizes["tenancy_zipf_s"]}
        step("noisy", p95_ratio=rec["noisy"]["p95_ratio"], bar=1.10)
        audit = watchtower.stats()  # the whole phase, the flood's traffic too
        if audit["violations"] or audit["ops_audited"] <= rec["drill"]["watchtower"]["ops_audited"]:
            raise AssertionError(f"tenancy: Watchtower after the noisy runs {audit}")
        rec["watchtower"] = audit
        stores = list(server.backend._stores.values())
        rec["stores"] = {"count": len(stores), "bytes": sum(s.nbytes() for s in stores),
                         "rows": sum(s.resident for s in stores)}
        rec["usage"] = chronoscope.tenant_usage()
        rec["admission"] = server.admission.report()
        rec["transitions"] = transitions
        rec["shed_wait_s"] = dict(shed_wait)
        rec["waits"] = dict(waits)
        rec["statuses"] = {w: dict(collections.Counter(a["status"] for a in answers
                                                      if a["where"] == w))
                           for w in ("load", "fold", "gate", "drill")}
    finally:
        await dep.stop()
        chronoscope.enabled = chronoscope_was
    counts = read_counts(dev)
    rec["launches"] = {k: counts[k] for k in ("mont_mul", "mont_exp")}
    if dev.type == "cuda" and min(rec["launches"].values()) <= 0:
        raise AssertionError(f"tenancy: B1 or B3 never launched: {rec['launches']}")
    if watchtower.attached or chronoscope.stats()["attached"]:
        raise AssertionError("tenancy: stop left the Watchtower or Chronoscope attached")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = TENANCY_BUDGET_S
    emit("tenancy", **{k: rec[k] for k in (
        "seconds", "budget_s", "keygen_s", "launches", "load", "folds", "stores", "gates")},
         noisy={k: rec["noisy"][k] for k in ("p95_ratio", "bar")},
         drill={k: rec["drill"][k] for k in ("s", "refused", "served_ciphertext")})
    return rec


HELIOGRAPH_BUDGET_S = 120.0
# configs/heliograph.toml's settings the phase overrides (printed);
# everything else stands as the file says
HELIOGRAPH_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the file names none: the reference's default is its "
                            "cpu host backend)",
    "proxy.port": "0 (an OS-assigned port for the file's 8080)",
    "targets": "east=proxy-east:8080 and west=proxy-west:8080 stand as the file says; on "
               "a sealed host neither name resolves, and the phase's canary transport "
               "fails them as such a resolver does (socket.gaierror EAI_NONAME) without "
               "a lookup leaving the host",
    "data": "bench_paillier_key(2048): K rows of one PSSE column, seeded plaintexts "
            "blinded on the card (B3, one pow_mod)",
}


def heliograph_config(dev):
    """configs/heliograph.toml as it stands (4 replicas, quorum 3, f = 1,
    [heliograph] on: cadence 5 s, jitter 0.5, deadline 2 s, slow-ms 250,
    population 4 under 512-bit canary keys, the five probe kinds, the
    loopback plus east and west, an unreachable streak of 3; the audit,
    /metrics and /slo on) with the `cuda` backend on `dev` and an
    OS-assigned port."""
    import pathlib

    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.load(pathlib.Path(__file__).resolve().parent / "configs" / "heliograph.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.device = dev.type
    cfg.proxy.port = 0
    return cfg


def sealed_transport(real, unresolved: set):
    """The canary client's transport with `unresolved` host names failing
    as a resolver that does not know them fails, before any lookup."""
    import socket

    async def transport(host, port, *a, **kw):
        if host in unresolved:
            raise socket.gaierror(socket.EAI_NONAME, "Name or service not known")
        return await real(host, port, *a, **kw)

    return transport


async def phase_heliograph(dev, sizes) -> dict:
    """configs/heliograph.toml served on the card (HELIOGRAPH_OVERRIDES
    printed): the prober's first cycle on the canary-only store; the
    corruption drill there (benchmarks/canary_overhead.py's drill: the
    prober's loop driven at `helio_drill_cadence`, one canary PSSE
    ciphertext corrupted on every replica past the HMAC boundary, loopback
    cycles counted until the sum probe reads `wrong_answer`, then the row
    re-put); K user rows blinded on the card (B3) and loaded by PutSet with
    the prober running at the file's cadence; user SumAlls, each the Python
    fold of exactly the K rows under n^2 and decrypting to the total; the
    kernel sentry's `cuda::` rows written as the baseline file
    (`sentry.baseline_path()`) and a second SumAll round compared against
    it; canary_overhead.py's
    shape: an open-loop window of GetSets and SumAlls with the prober off,
    then on; the observability routes. Gates: every user SumAll exact and
    on B1 (14 launches each at K = 8,192), B1's launches over the phase
    exactly the SumAlls' and the blinding's, none from a probe-only window;
    no probe `wrong_answer` before the drill; the drill's `wrong_answer`
    with only `canary_wrong_answer` Watchtower verdicts, one of them
    /canary's exemplar; /health's canary section, /metrics' dds_canary_*;
    east and west at their streak; no 500."""
    import os

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.clt import canary
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models.backend import get_backend
    from dds_tpu_torch.obs import sentry
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.obs.heliograph import seed_ciphertext_corruption
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    cfg = heliograph_config(dev)
    hc = cfg.heliograph
    extra, _ = canary.parse_canary_targets(hc.targets)
    K = sizes["helio_K"]
    fold_launches = (K - 1).bit_length() + 1  # the halving tree's levels and the fix
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    rec: dict = {"overrides": HELIOGRAPH_OVERRIDES, "K": K, "key_bits": sizes["key_bits"],
                 "replicas": len(cfg.replicas.endpoints), "quorum": cfg.replicas.byz_quorum_size,
                 "heliograph": {k: getattr(hc, k) for k in (
                     "cadence", "jitter", "deadline", "slow_ms", "population", "paillier_bits",
                     "rsa_bits", "probes", "targets", "unreachable_streak", "rate", "burst")},
                 "audit": cfg.obs.audit_enabled, "slo_route": cfg.obs.slo_route}

    def step(name: str, **kw) -> None:
        emit("heliograph_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    def b1() -> int:
        sync(dev)
        return mont_cuda.LAUNCHES["mont_mul"].value

    step("config", **rec)
    answers: list[dict] = []

    async def req(method: str, target: str, obj=None, where: str = "") -> tuple[int, bytes]:
        t0 = time.perf_counter()
        status, data = await http_request(
            "127.0.0.1", port, method, target,
            json.dumps(obj).encode() if obj is not None else None, timeout=600.0)
        answers.append({"where": where, "status": status,
                        "ms": (time.perf_counter() - t0) * 1e3})
        if status == 500:
            raise AssertionError(f"heliograph: {method} {target[:40]} answered 500")
        return status, data

    probes: list = []  # every ProbeResult the ledger records in the phase
    real_transport = canary.http_request
    canary.http_request = sealed_transport(real_transport, {t.host for t in extra})
    chronoscope_was = chronoscope.enabled
    chronoscope.enabled = True  # the file's launch profiles (the "cuts" line)
    os_karatsuba = os.environ.pop("DDS_KARATSUBA", None)
    metrics.reset()
    tracer.reset()
    reset_counts()  # path "heliograph" starts here
    dep = await launch(cfg)
    server = dep.server
    port = server.cfg.port
    h = server.heliograph
    record = h.ledger.record
    h.ledger.record = lambda r: (probes.append(r), record(r))[1]
    sumalls = 0  # user SumAlls answered 200, each exact
    try:
        if h is None or not watchtower.attached:
            raise AssertionError("heliograph: launch left the prober off or the Watchtower "
                                 "detached")
        loopback = h.targets[0]
        # -- the first green cycle on the canary-only store
        t = time.perf_counter()
        while h.cycles < 1:
            if time.perf_counter() - t > sizes["helio_first_wait_s"]:
                raise AssertionError("heliograph: no probe cycle within the wait")
            await asyncio.sleep(0.05)
        first = {r.kind: r.verdict for r in probes if r.target == loopback.label}
        rec["first"] = {"s": time.perf_counter() - t, "verdicts": first,
                        "b1_launches": b1()}
        step("first", **rec["first"])
        if set(first) != set(hc.probes) or any(v not in ("ok", "slow") for v in first.values()):
            raise AssertionError(f"heliograph: the first cycle read {first}")
        # -- the drill on the canary-only store, the prober's loop driven
        await h.stop()
        c = h.client
        base, n_t = h.cycles, len(h.targets)
        # the rows the loopback cycles' putgets re-put, in turn: corrupt the
        # last, so no putget heals it within the drill's budget
        first_loopback = base + (-base) % n_t
        victim = [(first_loopback + n_t * i) % c.population
                  for i in range(c.population)][-1]
        b1_drill = b1()
        mutated = seed_ciphertext_corruption(dep.replicas, c.keys[victim], PSSE_POS)
        passive, _ = await req("GET", f"/GetSet/{c.keys[victim]}", where="drill")
        t = time.perf_counter()
        # the loop's own rotation, driven until the sum probe has read the
        # corruption and east and west stand at their streak, at most
        # `helio_drill_cycles` loopback cycles
        loopback_cycles, detected_at, cycles_at = 0, None, None
        limit = first_loopback - base + sizes["helio_drill_cycles"] * n_t
        while h.cycles - base < limit:
            streaks = h.ledger.report()["region_streaks"]
            if detected_at is not None and all(
                    streaks.get(e.region, 0) >= hc.unreachable_streak for e in extra):
                break
            target = h.targets[h.cycles % n_t]
            await h.run_cycle(target)
            h.cycles += 1
            if target is loopback:
                loopback_cycles += 1
                if detected_at is None and h.ledger.last("sum").verdict == "wrong_answer":
                    detected_at, cycles_at = loopback_cycles, h.cycles - base
                    drill_s = time.perf_counter() - t
            await asyncio.sleep(sizes["helio_drill_cadence"])
        detected = detected_at is not None
        _, body = await req("GET", "/canary", where="drill")
        exemplar = json.loads(body)["kinds"]["sum"].get("last_failure", {}).get("trace_id")
        await dep.net.quiesce()
        kinds = sorted({v.invariant for v in watchtower.verdicts()})
        traces = {v.trace_id for v in watchtower.verdicts()}
        # the golden row re-put: the same frozen ciphertext under a newer tag
        healed = await c.probe_putget(loopback, c.mint_trace(), victim)
        await h.run_cycle(loopback)
        rec["drill"] = {"mutated": mutated, "row": victim, "passive_getset": passive,
                        "detected": detected, "loopback_cycles_to_detect": detected_at,
                        "cycles_to_detect": cycles_at, "s_to_detect": drill_s if detected
                        else None, "cycles_driven": h.cycles - base, "exemplar": exemplar,
                        "violation_kinds": kinds, "exemplar_filed": exemplar in traces,
                        "healed": healed.correct, "sum_after_heal": h.ledger.last("sum").verdict,
                        "b1_launches": b1() - b1_drill, "cadence_s": sizes["helio_drill_cadence"],
                        "regions": sorted(h.unreachable_regions())}
        step("drill", **rec["drill"])
        if not (detected and mutated == len(dep.replicas) and passive == 200):
            raise AssertionError(f"heliograph: the drill {rec['drill']}")
        if kinds != ["canary_wrong_answer"] or exemplar not in traces:
            raise AssertionError(f"heliograph: Watchtower after the drill {kinds}")
        h.start()  # the prober's own loop, at the file's cadence
        # -- the user's rows: blinding on the card (B3), then PutSet
        rng = random.Random(sizes["helio_seed"])
        plain = [rng.randrange(1 << 30) for _ in range(K)]
        client_be = get_backend("cuda", device=dev.type)
        before = b1()
        t = time.perf_counter()
        cts = pk.encrypt_batch(plain, client_be, min_batch=1)
        sync(dev)
        blind_s, blind_b1 = time.perf_counter() - t, b1() - before
        blind_stats = sentry.collect()  # the blinding's kernel.pow spans
        fold = host_product(cts, pk.nsquare)
        sem = asyncio.Semaphore(sizes["helio_inflight"])

        async def put(ct: int) -> None:
            async with sem:
                status, _ = await req("POST", "/PutSet", {"contents": [str(ct)]}, "load")
                if status != 200:
                    raise AssertionError(f"heliograph: a PutSet answered {status}")

        t = time.perf_counter()
        await asyncio.gather(*(put(ct) for ct in cts))
        load_s = time.perf_counter() - t
        rec["load"] = {"rows": K, "s": load_s, "putsets_per_s": K / load_s,
                       "blind_s": blind_s, "blind_b1_launches": blind_b1,
                       "inflight": sizes["helio_inflight"]}
        step("load", **rec["load"])

        async def sumall(where: str) -> float:
            nonlocal sumalls
            t0 = time.perf_counter()
            status, data = await req("GET", f"/SumAll?position=0&nsqr={pk.nsquare}",
                                     where=where)
            result = int(json.loads(data)["result"]) if status == 200 else None
            if result != fold or key.decrypt(result) != sum(plain):
                raise AssertionError(f"heliograph: a {where} SumAll answered {status}, not "
                                     f"the fold of the {K} user rows")
            sumalls += 1
            return (time.perf_counter() - t0) * 1e3

        # -- user SumAlls with the prober running, then the sentry's baseline
        before, n0 = b1(), sumalls
        tracer.reset()
        ms = [await sumall("sumall") for _ in range(sizes["helio_sumalls"])]
        per = (b1() - before) / (sumalls - n0)
        baseline_path = str(sentry.baseline_path())
        base_stats = sentry.collect()
        sentry.save_baseline(base_stats, baseline_path, overwrite=True)
        tracer.reset()
        ms2 = [await sumall("compare") for _ in range(sizes["helio_sumalls_compare"])]
        fresh = sentry.collect()
        rec["sumall"] = {"ms": ms, "ms_p50": statistics.median(ms), "b1_per_sumall": per,
                         "compare_ms": ms2}
        rec["sentry"] = {"platform": sentry.platform(), "baseline_path": baseline_path,
                         "blinding": blind_stats, "baseline": base_stats, "fresh": fresh,
                         "findings": sentry.compare(sentry.load_baseline(baseline_path), fresh)}
        step("sumall", **rec["sumall"])
        step("sentry", **rec["sentry"])
        if dev.type == "cuda" and per != fold_launches:
            raise AssertionError(f"heliograph: {per} B1 launches a user SumAll, "
                                 f"not {fold_launches}")
        # -- the canary's cost: an open-loop window, the prober off, then on
        keys_of = [k for k in sorted(server.stored_keys) if k not in server._canary_keys]
        window = sizes["helio_window_s"]

        def schedule(seed: int) -> list[tuple[str, float, str]]:
            srng = random.Random(seed)
            out, at = [], 0.0
            rate = sizes["helio_getset_rate"] + sizes["helio_sumall_rate"]
            share = sizes["helio_sumall_rate"] / rate
            while at < window:
                op = "SumAll" if srng.random() < share else "GetSet"
                out.append((op, at, keys_of[srng.randrange(len(keys_of))]))
                at += srng.expovariate(rate)
            return out

        async def drive(arrivals) -> list[dict]:
            out: list[dict] = []

            async def fire(op: str, k: str) -> None:
                target = (f"/GetSet/{k}" if op == "GetSet"
                          else f"/SumAll?position=0&nsqr={pk.nsquare}")
                t0 = time.perf_counter()
                status, data = await http_request("127.0.0.1", port, "GET", target,
                                                  timeout=600.0)
                out.append({"op": op, "status": status, "ms": (time.perf_counter() - t0) * 1e3,
                            "exact": op == "GetSet" or (
                                status == 200 and int(json.loads(data)["result"]) == fold)})

            t0, pending = time.perf_counter(), []
            for op, at, k in arrivals:
                delay = at - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                pending.append(asyncio.ensure_future(fire(op, k)))
            await asyncio.gather(*pending)
            return out

        windows = {}
        for label, on in (("off", False), ("on", True)):
            if not on:
                await h.stop()
            else:
                h.start()
            before, cycles0 = b1(), h.cycles
            with concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="helio") as pool:
                got = await asyncio.get_running_loop().run_in_executor(
                    pool, lambda: asyncio.run(drive(schedule(sizes["helio_seed"] + 1))))
            if any(a["status"] != 200 or not a["exact"] for a in got):
                raise AssertionError(f"heliograph: window {label}: "
                                     f"{[a for a in got if a['status'] != 200][:3]}")
            n_sum = sum(1 for a in got if a["op"] == "SumAll")
            sumalls += n_sum
            slo_ms = 250.0
            good = sum(1 for a in got if a["ms"] <= slo_ms)
            windows[label] = {
                "requests": len(got), "good_within_250ms": good, "sumalls": n_sum,
                "getset_p50_ms": pct([a["ms"] for a in got if a["op"] == "GetSet"], 50),
                "getset_p95_ms": pct([a["ms"] for a in got if a["op"] == "GetSet"], 95),
                "sumall_p50_ms": pct([a["ms"] for a in got if a["op"] == "SumAll"], 50),
                "sumall_p95_ms": pct([a["ms"] for a in got if a["op"] == "SumAll"], 95),
                "prober_cycles": h.cycles - cycles0, "b1_launches": b1() - before}
            step(f"window_{label}", **windows[label])
        rec["overhead"] = {**windows, "window_s": window,
                           "getset_rate": sizes["helio_getset_rate"],
                           "sumall_rate": sizes["helio_sumall_rate"],
                           "overhead_pct": (1.0 - windows["on"]["good_within_250ms"]
                                            / max(1, windows["off"]["good_within_250ms"])) * 100,
                           "reference_bar_pct": 1.0}
        step("overhead", overhead_pct=rec["overhead"]["overhead_pct"], bar_pct=1.0)
        # -- the observability routes on the card stack
        routes = {}
        for method, target, obj in (("GET", "/profile", None), ("GET", "/profile?fmt=folded", None),
                                    ("GET", "/canary", None), ("POST", "/_sync", {"keyset": []}),
                                    ("GET", "/_trace", None), ("GET", "/health", None),
                                    ("GET", "/metrics", None), ("GET", "/slo", None)):
            status, data = await req(method, target, obj, "routes")
            routes[f"{method} {target}"] = status
            if target == "/health":
                health = json.loads(data)["canary"]
            elif target == "/metrics":
                series = sorted({ln.split("{")[0].split(" ")[0] for ln in
                                 data.decode().splitlines() if ln.startswith("dds_canary_")})
            elif target == "/slo":
                streams = sorted(r for r in json.loads(data)["slo"]["routes"]
                                 if r.startswith("canary."))
            elif target == "/canary":
                report = json.loads(data)
        rec["routes"] = {"statuses": routes, "health": health, "series": series,
                         "slo_streams": streams}
        step("routes", **rec["routes"])
        expected = {"GET /profile": 200, "GET /profile?fmt=folded": 200, "GET /canary": 200,
                    "POST /_sync": 204, "GET /_trace": 404, "GET /health": 200,
                    "GET /metrics": 200, "GET /slo": 200}
        if routes != expected or "status" not in health or "dds_canary_probes_total" not in series:
            raise AssertionError(f"heliograph: the routes {rec['routes']}")
        await dep.net.quiesce()
        rec["watchtower"] = watchtower.stats()
        rec["violation_kinds"] = sorted({v.invariant for v in watchtower.verdicts()})
        rec["regions"] = sorted(h.unreachable_regions())
        rec["region_streaks"] = report["region_streaks"]
        rec["cycles"] = h.cycles
    finally:
        await dep.stop()
        canary.http_request = real_transport
        chronoscope.enabled = chronoscope_was
        if os_karatsuba is not None:
            os.environ["DDS_KARATSUBA"] = os_karatsuba
    by = collections.defaultdict(collections.Counter)
    lat = collections.defaultdict(list)
    for r in probes:
        by[f"{r.kind}@{r.region or 'loopback'}"][r.verdict] += 1
        if r.verdict in ("ok", "slow", "wrong_answer"):
            lat[r.kind].append(r.latency_s * 1e3)
    rec["verdicts"] = {k: dict(v) for k, v in sorted(by.items())}
    rec["probe_ms"] = {k: {"p50": pct(v, 50), "p95": pct(v, 95), "n": len(v)}
                       for k, v in sorted(lat.items())}
    counts = read_counts(dev)
    rec["launches"] = {k: counts[k] for k in ("mont_mul", "mont_exp")}
    rec["b1_expected"] = fold_launches * sumalls + rec["load"]["blind_b1_launches"]
    rec["user_sumalls"] = sumalls
    rec["statuses"] = {w: dict(collections.Counter(a["status"] for a in answers
                                                  if a["where"] == w))
                       for w in ("drill", "load", "sumall", "compare", "routes")}
    if dev.type == "cuda":
        if min(rec["launches"].values()) <= 0:
            raise AssertionError(f"heliograph: B1 or B3 never launched: {rec['launches']}")
        if rec["launches"]["mont_mul"] != rec["b1_expected"]:
            raise AssertionError(f"heliograph: {rec['launches']['mont_mul']} B1 launches, "
                                 f"expected {rec['b1_expected']} ({fold_launches} a user "
                                 f"SumAll and the blinding's): a probe folded on the card")
        if rec["first"]["b1_launches"] or rec["drill"]["b1_launches"]:
            raise AssertionError("heliograph: a probe-only window launched B1")
    if rec["violation_kinds"] != ["canary_wrong_answer"]:
        raise AssertionError(f"heliograph: Watchtower verdicts {rec['violation_kinds']}")
    if rec["regions"] != sorted(t.region for t in extra) or any(
            rec["region_streaks"].get(t.region, 0) < hc.unreachable_streak for t in extra):
        raise AssertionError(f"heliograph: region streaks {rec['region_streaks']}")
    if watchtower.attached or chronoscope.stats()["attached"]:
        raise AssertionError("heliograph: stop left the Watchtower or Chronoscope attached")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = HELIOGRAPH_BUDGET_S
    emit("heliograph", **{k: rec[k] for k in (
        "seconds", "budget_s", "launches", "b1_expected", "user_sumalls", "first", "drill",
        "load", "sumall", "verdicts", "probe_ms", "regions", "region_streaks",
        "violation_kinds")}, overhead={k: rec["overhead"][k] for k in (
            "overhead_pct", "reference_bar_pct")})
    return rec


SHARDED_BUDGET_S = 90.0
# configs/sharded.toml's and configs/stratum.toml's settings the phase
# overrides (printed); everything else stands as the files say
SHARDED_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the files name cpu, the reference's host backend)",
    "proxy.port": "0 (an OS-assigned port for the files' 8443)",
    "data": "bench_paillier_key(2048): rows of one PSSE column, seeded plaintexts "
            "blinded on the card (B3, one pow_mod a file)",
    "scatter": "the scatter SumAlls run with the launched proxy's resident min fold "
               "(the backend's device crossover, 256) set above K, so those aggregates "
               "take proxy.scatter_fold instead of the fused resident tree",
    "storage.dir": "stratum.toml's ./stratum in a temporary directory",
    "stratum.resident.max_rows": "4096 -> 512 rows a group, so stratum.toml's 2,048 rows "
                                 "(about 1,024 a group) pass the hot tier",
    "stratum.storage.warm_bytes": "128 MiB -> max_rows x 10 x 16 bytes (80 rows; "
                                  "benchmarks/tiered_fold.py's pop-factor rule), so the "
                                  "cold tier serves too",
}


def shard_config(dev, name: str):
    """configs/<name> as it stands, with the `cuda` backend on `dev` and an
    OS-assigned port (SHARDED_OVERRIDES)."""
    import pathlib

    from dds_tpu_torch.utils.config import DDSConfig

    cfg = DDSConfig.load(pathlib.Path(__file__).resolve().parent / "configs" / name)
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.device = dev.type
    cfg.proxy.port = 0
    return cfg


async def phase_sharded(dev, sizes) -> dict:
    """configs/sharded.toml, then configs/stratum.toml, served on the card
    (SHARDED_OVERRIDES printed). sharded.toml: a Constellation of 4 groups
    of 4 replicas and a spare (quorum 3, f = 1), proactive recovery and
    anti-entropy in each group, [resident] (256 / 65,536 rows) and
    [analytics]; K rows blinded on the card (B3) and loaded by PutSet
    `sharded_inflight` at a time; SumAlls through the fused S = 4 resident
    tree (`proxy.resident_fold`, B1 launches the tree's levels), then in
    the Karatsuba modes 1 and 2, then through the scatter fold
    (`proxy.scatter_fold`: one device fold a group, merged by
    combine_partials), each the Python-int fold of the K ciphertexts and
    decrypting to the total; `sharded_new` more rows once the pools exist,
    ingested off the request path, the next SumAll ingesting 0 rows on its
    fold path; one REST MatVec of `sharded_R` rows through Prism's
    per-group scatter (each group's columns gathered once from its pool
    through `rows_for`, B1 launches the groups' weighted ladders), equal
    row by row to the port's unsharded `evaluate` on the marshaling path
    (its launches not counted) and decrypting to W @ x; GET /shards (4 groups, the epoch as
    ETag, 304 on If-None-Match), /health's shard_epoch and reshard_state,
    /metrics' dds_shard_groups, POST /_reshard 404 (admin-routes off); one
    IWrite under a stale epoch sent straight to a replica of a group that
    does not own its key, answered by a WrongShard whose MAC verifies and
    stored nowhere. stratum.toml: 2 groups, [storage] in a temporary
    directory, [resident] max-rows cut to `stratum_max_rows` and the warm
    tier to tiered_fold.py's rule (SHARDED_OVERRIDES); `stratum_K` rows
    blinded on the card, `stratum_sumalls` SumAlls through Stratum, exact,
    no reset, the warm and cold tiers holding rows and the cold one read,
    the dds_tier_* gauges on /metrics. Launch counts are zeroed before
    sharded.toml's launch and read after its stop (path "sharded"), and
    zeroed after stratum.toml's load and read after its stop (path
    "stratum"); on the card B1 and B3 must have launched on "sharded" and
    B1 on "stratum", by each SumAll. Printed: wall times, the SumAll routes'
    p50/p95, the load's rate, the Watchtower's verdict kinds, the phase's
    seconds beside its 90 s budget."""
    import os
    import tempfile

    from dds_tpu_torch.analytics import Prism
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.core import messages as M
    from dds_tpu_torch.http.miniserver import http_request, http_request_full
    from dds_tpu_torch.models.backend import get_backend
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import foldmany, mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx
    from dds_tpu_torch.parallel.mesh import mesh_fold_launches
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils import sigs
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    cfg = shard_config(dev, "sharded.toml")
    sh = cfg.shard
    K, new, R = sizes["sharded_K"], sizes["sharded_new"], sizes["sharded_R"]
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    n2 = pk.nsquare
    rec: dict = {"overrides": SHARDED_OVERRIDES, "K": K, "new": new, "R": R,
                 "key_bits": sizes["key_bits"],
                 "shard": {k: getattr(sh, k) for k in (
                     "count", "vnodes_per_group", "replicas_per_group",
                     "sentinent_per_group", "quorum_size", "max_faults")},
                 "recovery": cfg.recovery.enabled,
                 "anti_entropy": cfg.recovery.anti_entropy_enabled,
                 "resident": {"initial_rows": cfg.resident.initial_rows,
                              "max_rows": cfg.resident.max_rows},
                 "audit": cfg.obs.audit_enabled}

    def step(name: str, **kw) -> None:
        emit("sharded_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    def b1() -> int:
        sync(dev)
        return mont_cuda.LAUNCHES["mont_mul"].value

    step("config", **{k: v for k, v in rec.items() if k != "overrides"})
    answers: list[dict] = []

    async def req(method: str, target: str, obj=None, where: str = "",
                  headers=None) -> tuple[int, dict, bytes]:
        t0 = time.perf_counter()
        status, hdrs, data = await http_request_full(
            "127.0.0.1", port, method, target,
            json.dumps(obj).encode() if obj is not None else None, timeout=600.0,
            headers=headers)
        answers.append({"where": where, "status": status,
                        "ms": (time.perf_counter() - t0) * 1e3})
        if status == 500:
            raise AssertionError(f"sharded: {method} {target[:40]} answered 500")
        return status, hdrs, data

    async def load(rows: list, where: str) -> float:
        sem = asyncio.Semaphore(sizes["sharded_inflight"])

        async def put(row) -> None:
            async with sem:
                status, _, _ = await req("POST", "/PutSet", {"contents": row}, where)
                if status != 200:
                    raise AssertionError(f"sharded: a PutSet answered {status}")

        t = time.perf_counter()
        await asyncio.gather(*(put(r) for r in rows))
        return time.perf_counter() - t

    async def sumall(where: str, want: int, total: int) -> float:
        t0 = time.perf_counter()
        status, _, data = await req("GET", f"/SumAll?position=0&nsqr={n2}", where=where)
        result = int(json.loads(data)["result"]) if status == 200 else None
        if result != want or key.decrypt(result) != total:
            raise AssertionError(f"sharded: a {where} SumAll answered {status}, not the "
                                 f"fold of the stored rows")
        return (time.perf_counter() - t0) * 1e3

    chronoscope_was = chronoscope.enabled
    chronoscope.enabled = True  # the files' launches profile (the "cuts" line)
    os_karatsuba = os.environ.pop("DDS_KARATSUBA", None)
    metrics.reset()
    tracer.reset()
    reset_counts()  # path "sharded" starts here
    t = time.perf_counter()
    dep = await launch(cfg)
    rec["launch_s"] = time.perf_counter() - t
    server = dep.server
    port = server.cfg.port
    const = dep.constellation
    compare_b1 = 0  # the unsharded reference MatVec's launches, not the path's
    try:
        if const is None or len(const.groups) != sh.count or server._shards is None \
                or server._resident is None or not watchtower.attached:
            raise AssertionError("sharded: launch did not bring up the Constellation, "
                                 "the resident plane and the audit")
        # -- the rows: blinding on the card (B3), then PutSet
        rng = random.Random(sizes["sharded_seed"])
        plain = [rng.randrange(1 << 30) for _ in range(K + new)]
        client_be = get_backend("cuda", device=dev.type)
        before = b1()
        t = time.perf_counter()
        cts = pk.encrypt_batch(plain, client_be, min_batch=1)
        sync(dev)
        rec["blind"] = {"s": time.perf_counter() - t, "b1_launches": b1() - before}
        want = host_product(cts[:K], n2)
        load_s = await load([[str(c)] for c in cts[:K]], "load")
        parts = const.router.partition_keys(sorted(server.stored_keys))
        rec["load"] = {"rows": K, "s": load_s, "putsets_per_s": K / load_s,
                       "inflight": sizes["sharded_inflight"],
                       "keys_per_group": {g: len(v) for g, v in sorted(parts.items())}}
        step("load", **rec["load"], blind=rec["blind"])
        if len(parts) != sh.count:
            raise AssertionError(f"sharded: the rows span {len(parts)} groups")
        # -- SumAlls through the fused S = 4 resident tree
        total = sum(plain[:K])
        tracer.reset()
        before = b1()
        ms_res = [await sumall("resident", want, total) for _ in range(sizes["sharded_sumalls"])]
        spans = tracer.summary()
        group_sizes = [len(v) for _, v in sorted(parts.items())]
        rec["resident_sumall"] = {
            "ms": ms_res, "p50_ms": pct(ms_res, 50), "p95_ms": pct(ms_res, 95),
            "b1_per_sumall": (b1() - before) / len(ms_res),
            "b1_expected": mesh_fold_launches([group_sizes]),
            "resident_folds": spans.get("proxy.resident_fold", {}).get("count", 0),
            "fold_mean_ms": spans.get("proxy.resident_fold", {}).get("mean_ms")}
        step("resident_sumall", **rec["resident_sumall"])
        if rec["resident_sumall"]["resident_folds"] != len(ms_res) or \
                "proxy.scatter_fold" in spans:
            raise AssertionError(f"sharded: the SumAlls did not take the fused tree: "
                                 f"{sorted(spans)}")
        if dev.type == "cuda" and rec["resident_sumall"]["b1_per_sumall"] != \
                rec["resident_sumall"]["b1_expected"]:
            raise AssertionError(f"sharded: a fused-tree SumAll launched "
                                 f"{rec['resident_sumall']['b1_per_sumall']} mont_mul, not "
                                 f"{rec['resident_sumall']['b1_expected']}")
        # -- the same SumAlls through the fused tree in the Karatsuba modes:
        # mode 1 (B4 + k1 + REDC) and mode 2 (B5 + REDC), their own kernels only
        rec["modes"] = {}
        for mode in ("1", "2"):
            tracer.reset()
            was = read_counts(dev)
            os.environ["DDS_KARATSUBA"] = mode
            try:
                ms_mode = [await sumall(f"resident_mode{mode}", want, total)
                           for _ in range(sizes["sharded_mode_sumalls"])]
            finally:
                os.environ.pop("DDS_KARATSUBA", None)
            now = read_counts(dev)
            spans = tracer.summary()
            rec["modes"][mode] = {
                "ms": ms_mode, "p50_ms": pct(ms_mode, 50),
                "launches": check_mode_launches(dev, {k: now[k] - was[k] for k in now},
                                                mode, "sharded fused-tree SumAll"),
                "resident_folds": spans.get("proxy.resident_fold", {}).get("count", 0)}
            step(f"resident_mode{mode}", **rec["modes"][mode])
            if rec["modes"][mode]["resident_folds"] != len(ms_mode) or \
                    "proxy.scatter_fold" in spans:
                raise AssertionError(f"sharded: the mode-{mode} SumAlls did not take the "
                                     f"fused tree: {sorted(spans)}")
        # -- SumAlls through the scatter fold (the plane's min fold above K)
        min_fold = server._resident_min_fold
        server._resident_min_fold = K + new + 1
        tracer.reset()
        before = b1()
        try:
            ms_sc = [await sumall("scatter", want, total)
                     for _ in range(sizes["sharded_sumalls"])]
        finally:
            server._resident_min_fold = min_fold
        spans = tracer.summary()
        rec["scatter_sumall"] = {
            "ms": ms_sc, "p50_ms": pct(ms_sc, 50), "p95_ms": pct(ms_sc, 95),
            "b1_per_sumall": (b1() - before) / len(ms_sc),
            # one device fold a group (each group is past the crossover)
            "b1_expected": sum(mont_cuda.fold_launches(k) for k in group_sizes),
            "scatter_folds": spans.get("proxy.scatter_fold", {}).get("count", 0),
            "fold_mean_ms": spans.get("proxy.scatter_fold", {}).get("mean_ms"),
            "resident_min_fold": min_fold}
        step("scatter_sumall", **rec["scatter_sumall"])
        if rec["scatter_sumall"]["scatter_folds"] != len(ms_sc) or \
                "proxy.resident_fold" in spans:
            raise AssertionError(f"sharded: the SumAlls did not scatter: {sorted(spans)}")
        if dev.type == "cuda" and (min(group_sizes) < server.backend.min_device_batch or
                                   rec["scatter_sumall"]["b1_per_sumall"] !=
                                   rec["scatter_sumall"]["b1_expected"]):
            raise AssertionError(f"sharded: a scatter SumAll launched "
                                 f"{rec['scatter_sumall']['b1_per_sumall']} mont_mul, not one "
                                 f"fold a group ({rec['scatter_sumall']['b1_expected']}; "
                                 f"groups {group_sizes})")
        # -- writes once the pools exist: ingested off the request path
        pools = [server._resident.pool(g, n2) for g in const.gids]
        t = time.perf_counter()
        await load([[str(c)] for c in cts[K:]], "new")
        await wait_ingested(server)
        ingest_s = time.perf_counter() - t
        served = sum(p._served[1] for p in pools)
        ms_new = await sumall("post_write", host_product(cts, n2), sum(plain))
        rec["write_ingest"] = {"rows": new, "s": ingest_s, "sumall_ms": ms_new,
                               "fold_path_ingested": sum(p._served[1] for p in pools) - served,
                               "pool_rows": [p.resident for p in pools],
                               "dropped_pending": server._resident.stats()["dropped_pending"]}
        step("write_ingest", **rec["write_ingest"])
        if rec["write_ingest"]["fold_path_ingested"] != 0:
            raise AssertionError(f"sharded: the SumAll after the writes ingested "
                                 f"{rec['write_ingest']['fold_path_ingested']} rows")
        # -- one MatVec through Prism's per-group scatter
        by_key = {sigs.key_from_set([str(c)]): (c, x) for c, x in zip(cts, plain)}
        keys = sorted(by_key)
        ciphers = [by_key[k][0] for k in keys]
        xs = [by_key[k][1] for k in keys]
        wrng = np.random.default_rng(sizes["sharded_seed"] + 1)
        W = [[int(w) for w in wrng.integers(0, 1 << 16, len(keys))] for _ in range(R)]
        # each group's columns must gather once, from its pool, through
        # the plane's rows_for
        plane = server._resident
        gathers = []
        real_rows_for = plane.rows_for

        def counting(gid, *args, **kw):
            got = real_rows_for(gid, *args, **kw)
            gathers.append((gid, None if got is None else tuple(got.shape)))
            return got

        matvec_parts = server.prism._partition(keys)
        # a group below the crossover (R x its columns) folds on the host
        # from the ints, without a gather; on the card every group is past it
        device_parts = [(g, ix) for g, ix in matvec_parts
                        if R * len(ix) >= server.backend.min_device_batch]
        L = ModCtx.make(n2).L
        want_gathers = sorted((g, (len(ix), L)) for g, ix in device_parts)
        digits = -(-max(w.bit_length() for row in W for w in row) // 4)
        tracer.reset()
        before = b1()
        plane.rows_for = counting
        try:
            status, _, data = await req("POST", f"/MatVec?position=0&nsqr={n2}",
                                        {"weights": W}, "matvec")
        finally:
            del plane.rows_for
        matvec_b1 = b1() - before
        spans = tracer.summary()
        if status != 200 or json.loads(data)["keys"] != keys:
            raise AssertionError(f"sharded: MatVec answered {status}")
        got = [int(c) for c in json.loads(data)["result"]]
        # the reference: Prism without a plane or an owner, one weighted
        # fold over the whole column on the marshaling path
        before = b1()
        unsharded = await Prism(backend=server.backend, max_rows=R).evaluate(
            "MatVec", keys, ciphers, W, n2)
        compare_b1 = b1() - before
        rec["matvec"] = {"R": R, "K": len(keys), "groups": len(matvec_parts),
                         "ms": spans.get("http.POST.MatVec", {}).get("mean_ms"),
                         "b1_launches": matvec_b1,
                         "b1_expected": sum(foldmany.fold_weighted_launches(len(ix), digits)
                                            for _, ix in device_parts),
                         "device_groups": len(device_parts),
                         "gathers": sorted(gathers), "one_gather_a_group":
                         sorted(gathers) == want_gathers,
                         "equals_unsharded_marshaling": got == unsharded,
                         "decrypt_ok": [key.decrypt(c) for c in got] ==
                         [sum(w * x for w, x in zip(row, xs)) for row in W]}
        step("matvec", **rec["matvec"])
        if not (rec["matvec"]["equals_unsharded_marshaling"] and rec["matvec"]["decrypt_ok"]
                and rec["matvec"]["one_gather_a_group"]) or len(matvec_parts) != sh.count:
            raise AssertionError(f"sharded: the MatVec {rec['matvec']}")
        if dev.type == "cuda" and (matvec_b1 != rec["matvec"]["b1_expected"] or
                                   len(device_parts) != sh.count):
            raise AssertionError(f"sharded: the MatVec launched {matvec_b1} mont_mul on "
                                 f"{len(device_parts)} device groups, not "
                                 f"{rec['matvec']['b1_expected']} on {sh.count}")
        # -- the shard routes
        status, hdrs, data = await req("GET", "/shards", where="routes")
        shards = json.loads(data)
        etag = hdrs.get("etag")
        cond, _, _ = await req("GET", "/shards", where="routes", headers={"If-None-Match": etag})
        hst, _, hdata = await req("GET", "/health", where="routes")
        health = json.loads(hdata)
        rst, _, _ = await req("POST", "/_reshard", {"source": "s0"}, "routes")
        mst, _, mdata = await req("GET", "/metrics", where="routes")
        shard_series = sorted(ln for ln in mdata.decode().splitlines()
                              if ln.startswith(("dds_shard_groups", "dds_shard_epoch")))
        rec["routes"] = {"shards": status, "groups": sorted(shards["groups"]),
                         "epoch": shards["map"]["epoch"], "etag": etag, "if_none_match": cond,
                         "health": hst, "shard_epoch": health.get("shard_epoch"),
                         "reshard_state": health.get("reshard_state"),
                         "health_groups": sorted(health.get("shards", {})),
                         "reshard": rst, "metrics": mst, "series": shard_series}
        step("routes", **rec["routes"])
        if (status, cond, hst, rst, mst) != (200, 304, 200, 404, 200) or \
                len(shards["groups"]) != sh.count or health.get("shard_epoch") != 1 or \
                health.get("reshard_state") != "stable" or etag != '"1"':
            raise AssertionError(f"sharded: the routes {rec['routes']}")
        # -- a stale-epoch IWrite straight to the replicas of a non-owning
        # group that coordinate now (proactive recovery rotates them through
        # sentinence, and a sentinent spare ignores the proxy)
        smap = const.manager.current()
        stale_key = next(k for k in (f"stale-{i}" for i in range(256))
                         if smap.owner(k) != "s0")
        targets = [n for n in const.group("s0").replicas.values() if n.behavior == "healthy"]
        replies: list = []

        async def spy(sender, msg) -> None:
            replies.append((sender, msg))

        dep.net.register("sharded-spy", spy)
        secret = cfg.security.proxy_mac_secret.encode()
        value = ["stale-write"]
        sent = {}
        for node in targets:
            nonce = sigs.generate_nonce()
            sent[node.addr] = nonce + cfg.security.nonce_challenge_increment
            dep.net.send("sharded-spy", node.addr, M.Envelope(
                M.IWrite(stale_key, value), nonce,
                sigs.proxy_signature(secret, stale_key, nonce, value), epoch=0))
        await dep.net.quiesce()
        fences = [(sender, m) for sender, m in replies if isinstance(m, M.WrongShard)]
        stored = [n.repository.get(stale_key, (None, None))[1] for n in dep.replicas.values()]
        rec["fence"] = {"key_owner": smap.owner(stale_key),
                        "replicas": [n.name for n in targets], "replies": len(replies),
                        "wrong_shard": len(fences),
                        "epochs": sorted({m.epoch for _, m in fences}),
                        "macs_ok": bool(fences) and all(
                            m.key == stale_key and m.nonce == sent.get(sender) and
                            sigs.validate_proxy_signature(secret, stale_key, m.nonce,
                                                          m.signature,
                                                          ["wrong-shard", m.epoch])
                            for sender, m in fences),
                        "stored_anywhere": any(v == value for v in stored)}
        step("fence", **rec["fence"])
        if not rec["fence"]["macs_ok"] or rec["fence"]["stored_anywhere"]:
            raise AssertionError(f"sharded: the stale-epoch IWrite {rec['fence']}")
        await dep.net.quiesce()
        rec["watchtower"] = watchtower.stats()
        rec["violation_kinds"] = sorted({v.invariant for v in watchtower.verdicts()})
    finally:
        await dep.stop()
        chronoscope.enabled = chronoscope_was
        if os_karatsuba is not None:
            os.environ["DDS_KARATSUBA"] = os_karatsuba
    counts = read_counts(dev)
    rec["launches"] = {"mont_mul": counts["mont_mul"] - compare_b1,
                       "mont_exp": counts["mont_exp"]}
    rec["compare_b1_launches"] = compare_b1
    rec["sharded_s"] = time.perf_counter() - t_phase
    # -- configs/stratum.toml: 2 groups, Stratum in a temporary directory,
    # its hot and warm tiers cut so the rows reach the cold tier
    # (STRATUM_OVERRIDES)
    t_stratum = time.perf_counter()
    scfg = shard_config(dev, "stratum.toml")
    hot = sizes["stratum_max_rows"]
    scfg.resident.max_rows = hot
    scfg.resident.initial_rows = min(scfg.resident.initial_rows, hot)
    scfg.storage.warm_bytes = hot * sizes["tier_pop_factor"] * 16
    srng = random.Random(sizes["sharded_seed"] + 2)
    splain = [srng.randrange(1 << 30) for _ in range(sizes["stratum_K"])]
    scts = pk.encrypt_batch(splain, client_be, min_batch=1)
    want = host_product(scts, n2)
    with tempfile.TemporaryDirectory() as tier_dir:
        scfg.storage.dir = tier_dir
        dep = await launch(scfg)
        port = dep.server.cfg.port
        try:
            load_s = await load([[str(c)] for c in scts], "stratum_load")
            sparts = dep.constellation.router.partition_keys(sorted(dep.server.stored_keys))
            reset_counts()  # path "stratum" starts here: the server's folds alone
            tracer.reset()
            ms, b1_each = [], []
            for _ in range(sizes["stratum_sumalls"]):  # the first ingests and tiers
                before = b1()
                ms.append(await sumall("stratum", want, sum(splain)))
                b1_each.append(b1() - before)
            spans = tracer.summary()
            _, _, mdata = await req("GET", "/metrics", where="stratum")
            tier_series = sorted({ln.split("{")[0].split(" ")[0]
                                  for ln in mdata.decode().splitlines()
                                  if ln.startswith("dds_tier_")})
            stats = dep.server._stratum.stats()
            rec["stratum"] = {"groups": len(dep.constellation.groups),
                              "rows": len(scts), "max_rows": hot,
                              "warm_bytes": scfg.storage.warm_bytes,
                              "keys_per_group": {g: len(v) for g, v in sorted(sparts.items())},
                              "load_s": load_s, "sumall_ms": ms, "b1_per_sumall": b1_each,
                              "resident_folds":
                                  spans.get("proxy.resident_fold", {}).get("count", 0),
                              "series": tier_series, "tiers": stats["tiers"],
                              "hits": stats["hits"], "cold_reads": stats["cold_reads"],
                              "resets": dep.server._resident.stats()["resets"]}
        finally:
            await dep.stop()
    counts = read_counts(dev)
    rec["stratum"]["launches"] = {"mont_mul": counts["mont_mul"]}
    rec["stratum"]["s"] = time.perf_counter() - t_stratum
    step("stratum", **rec["stratum"])
    st = rec["stratum"]
    if st["groups"] != scfg.shard.count or "dds_tier_rows" not in tier_series:
        raise AssertionError(f"sharded: stratum.toml {st}")
    if st["resident_folds"] != len(ms) or "proxy.fold" in spans or \
            "proxy.scatter_fold" in spans:
        raise AssertionError(f"sharded: stratum.toml's SumAlls did not fold through "
                             f"Stratum: {sorted(spans)}")
    if st["resets"] or min(st["keys_per_group"].values()) <= hot or \
            st["tiers"]["warm"]["rows"] <= 0 or st["tiers"]["cold"]["rows"] <= 0 or \
            st["cold_reads"] <= 0:
        raise AssertionError(f"sharded: stratum.toml's rows did not stream from the warm "
                             f"and cold tiers without a reset: {st}")
    if dev.type == "cuda" and min(b1_each) <= 0:
        raise AssertionError(f"sharded: a stratum.toml SumAll launched no mont_mul: {b1_each}")
    rec["statuses"] = {w: dict(collections.Counter(a["status"] for a in answers
                                                  if a["where"] == w))
                       for w in sorted({a["where"] for a in answers})}
    if dev.type == "cuda" and min(rec["launches"]["mont_mul"], rec["launches"]["mont_exp"],
                                  rec["stratum"]["launches"]["mont_mul"]) <= 0:
        raise AssertionError(f"sharded: B1 or B3 never launched: {rec['launches']}, "
                             f"stratum {rec['stratum']['launches']}")
    if watchtower.attached or chronoscope.stats()["attached"]:
        raise AssertionError("sharded: stop left the Watchtower or Chronoscope attached")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = SHARDED_BUDGET_S
    emit("sharded", **{k: rec[k] for k in (
        "seconds", "budget_s", "launch_s", "launches", "compare_b1_launches", "load",
        "blind", "resident_sumall", "modes", "scatter_sumall", "write_ingest", "matvec",
        "routes",
        "fence", "violation_kinds", "stratum", "statuses")})
    return rec


CHAOS_BUDGET_S = 60.0
# the restarted proxy's first SumAll retries a cold tag round against its
# request budget (ROADMAP §C 5): 4.7-23.4 s at 2,064 rows in PR 19's runs,
# 254.2 s once; past this deadline the phase fails at once with its cause
# named, so one such tail cannot take the run past its time limit
CHAOS_RESTART_DEADLINE_S = 120.0
# configs/default.toml's settings the phase overrides (printed); everything
# else stands as the file says
CHAOS_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the file's cpu is the reference's host backend)",
    "attacks.enabled": "true (the file's false: replicas refuse Trudy's backdoors)",
    "attacks.chaos_enabled": "true: the transport is a ChaosNet, the attacker a Nemesis",
    "attacks.chaos_seed": 19,
    "proxy.stored_keys_path": "keys.json in a temporary directory",
    "data": "bench_paillier_key(2048): rows of one PSSE column, seeded plaintexts "
            "blinded on the card (B3, one pow_mod)",
    "load.inflight": "8, not 64: the file's admission and 250 ms PutSet objective "
                     "(64 in flight burn it and shed the aggregate class for the "
                     "SLO windows' length, as the bulwark phase found)",
}
# the phase's fault schedule, in order (printed)
CHAOS_SCHEDULE = (
    "clean: 1 SumAll (Nemesis draws each attack's victims from the supervisor's "
    "active replicas of the moment)",
    "link faults on every link (drop 0.02, duplicate 0.02, reorder 0.02, corrupt 0.01): "
    "8 PutSets, 3 SumAlls; then cleared",
    "Nemesis delay on f victims (0.02 s + U(0, 0.02)): 3 SumAlls",
    "Nemesis partition of f victims: 8 PutSets, 3 SumAlls",
    "Nemesis flood of f victims (25 junk Envelopes each): 3 SumAlls",
    "heal; every endpoint but quorum - 1 active replicas cut off under a short request "
    "budget: 1 SumAll answering 503 with Retry-After; heal; 1 SumAll",
    "proxy restart on the snapshot (the same replicas and quorum client, a cold tag "
    "cache): the first SumAll (retried on 503 + Retry-After)",
    "every acknowledged PutSet read back; the Watchtower's verdicts",
)


def chaos_config(dev, keys_path: str):
    """configs/default.toml as it stands with CHAOS_OVERRIDES: the `cuda`
    backend on `dev`, Trudy's consent, the seeded ChaosNet and the
    stored-keys snapshot at `keys_path`."""
    cfg = bulwark_config(dev)
    cfg.attacks.enabled = True
    cfg.attacks.chaos_enabled = True
    cfg.attacks.chaos_seed = CHAOS_OVERRIDES["attacks.chaos_seed"]
    cfg.proxy.stored_keys_path = keys_path
    return cfg


async def phase_chaos(dev, sizes) -> dict:
    """configs/default.toml served on the card over a seeded ChaosNet with
    Nemesis armed and the proxy's stored-keys snapshot (CHAOS_OVERRIDES
    printed): 9 endpoints, 2 spares, quorum 5, f = 2, proactive recovery,
    anti-entropy, Bulwark, the audit. `chaos_K` rows blinded on the card
    (B3) and loaded by PutSet on a clean fabric; then CHAOS_SCHEDULE: a
    clean SumAll; seeded link faults on every link with PutSets and
    SumAlls (the trace's actions counted); Nemesis's delay, partition
    (with PutSets) and flood of f victims, each with SumAlls; heal, a
    quorum-breaking partition under a short request budget whose SumAll
    answers 503 with Retry-After, heal and a SumAll; the proxy stopped
    and a fresh one started on the same replicas, quorum client and
    snapshot (a cold tag cache), its stored keys every acknowledged key, its first
    SumAll equal to the last one before the restart; every acknowledged
    PutSet read back; the Watchtower's verdicts. Every SumAll that
    answers 200 is the Python-int fold of the acknowledged rows and
    decrypts to their total, and on the card launched exactly one B1 a
    fold level (`fold_launches` of the stored keys); a PutSet or SumAll
    answering 503 or 429 with Retry-After is retried after it (counted).
    Launch counts are zeroed before the launch and read after the stop
    (path "chaos"): B1 = the SumAlls' levels + the blinding's 2, B3 1.
    The restarted proxy's first SumAll fails the phase if its retries
    pass CHAOS_RESTART_DEADLINE_S. Printed: each step's SumAll ms
    (p50/p95), retries and trace counts, the restart's retries, the
    phase's seconds beside its 60 s budget."""
    import tempfile

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.core.chaos import ChaosNet, LinkFaults
    from dds_tpu_torch.http.miniserver import http_request_full
    from dds_tpu_torch.http.server import DDSRestServer
    from dds_tpu_torch.malicious.trudy import Nemesis
    from dds_tpu_torch.models.backend import get_backend
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.slo import SloEngine
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.run import SUPERVISOR_NAME, launch, proxy_config
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    K, puts = sizes["chaos_K"], sizes["chaos_puts"]
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    n2 = pk.nsquare
    target = f"/SumAll?position=0&nsqr={n2}"
    rec: dict = {"K": K, "puts_a_step": puts, "key_bits": sizes["key_bits"],
                 "overrides": CHAOS_OVERRIDES, "schedule": CHAOS_SCHEDULE,
                 "budget_s": CHAOS_BUDGET_S, "restart_deadline_s": CHAOS_RESTART_DEADLINE_S}
    answers: list[dict] = []

    def step(name: str, **kw) -> None:
        emit("chaos_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    def b1() -> int:
        sync(dev)
        return mont_cuda.LAUNCHES["mont_mul"].value

    async def call(method: str, target_: str, obj=None, where: str = ""):
        t0 = time.perf_counter()
        status, headers, data = await http_request_full(
            "127.0.0.1", port, method, target_,
            json.dumps(obj).encode() if obj is not None else None, timeout=600.0)
        answers.append({"where": where, "status": status,
                        "ms": (time.perf_counter() - t0) * 1e3})
        if status not in (200, 429, 503) or (
                status != 200 and int(headers.get("retry-after", 0)) < 1):
            raise AssertionError(f"chaos: {method} {target_[:40]} at {where} answered "
                                 f"{status} {headers} {data[:160]!r}")
        return status, headers, data

    acked: dict[str, int] = {}  # acknowledged key -> ciphertext
    plain_of: dict[int, int] = {}

    async def put_rows(cts: list, where: str, inflight: int) -> dict:
        sem = asyncio.Semaphore(inflight)
        retries = collections.Counter()

        async def put(c) -> None:
            async with sem:
                while True:
                    status, headers, data = await call("POST", "/PutSet",
                                                       {"contents": [str(c)]}, where)
                    if status == 200:
                        acked[data.decode()] = c
                        return
                    retries[status] += 1  # a client honouring Retry-After
                    await asyncio.sleep(int(headers["retry-after"]))

        t = time.perf_counter()
        await asyncio.gather(*(put(c) for c in cts))
        return {"rows": len(cts), "s": time.perf_counter() - t,
                "retries": dict(retries)}

    async def sumall(where: str, retry: bool = True, deadline_s: float | None = None) -> dict:
        """One SumAll (retried after a 503 or 429 when `retry`, for at
        most `deadline_s` seconds when given): its status, ms, B1
        launches and ciphertext; a 200 must be the fold of the
        acknowledged rows with one B1 launch a level."""
        want = host_product(list(acked.values()), n2)
        tries = collections.Counter()
        t0 = time.perf_counter()
        while True:
            before = b1()
            status, headers, data = await call("GET", target, where=where)
            launched = b1() - before
            if status == 200 or not retry:
                break
            tries[status] += 1
            if launched:
                raise AssertionError(f"chaos: a {status} SumAll at {where} folded")
            wait = int(headers["retry-after"])
            if deadline_s is not None and time.perf_counter() - t0 + wait > deadline_s:
                raise AssertionError(
                    f"chaos: the SumAll at {where} answered {dict(tries)} for "
                    f"{time.perf_counter() - t0:.1f} s, past its {deadline_s} s deadline "
                    f"(ROADMAP §C 5: a cold tag round retried against the request budget)")
            await asyncio.sleep(wait)
        out = {"status": status, "ms": (time.perf_counter() - t0) * 1e3,
               "retries": dict(tries), "b1": launched,
               "b1_expected": mont_cuda.fold_launches(len(acked))}
        if status == 200:
            result = int(json.loads(data)["result"])
            if result != want or key.decrypt(result) != sum(plain_of[c] for c in
                                                             acked.values()):
                raise AssertionError(f"chaos: a SumAll at {where} is not the fold of the "
                                     f"{len(acked)} acknowledged rows")
            if dev.type == "cuda" and launched != out["b1_expected"]:
                raise AssertionError(f"chaos: a SumAll at {where} launched {launched} "
                                     f"mont_mul, not {out['b1_expected']}")
            out["result"] = result
        return out

    def summary(runs: list[dict]) -> dict:
        ms = [r["ms"] for r in runs]
        return {"ms": ms, "p50_ms": pct(ms, 50), "p95_ms": pct(ms, 95),
                "retries": dict(sum((collections.Counter(r["retries"]) for r in runs),
                                    collections.Counter())),
                "b1": [r["b1"] for r in runs], "b1_expected": runs[-1]["b1_expected"]}

    def trace_counts(net, since: int = 0) -> dict:
        return dict(collections.Counter(e[4].split("=")[0] for e in net.trace[since:]))

    rng = random.Random(sizes["chaos_seed"])
    plain = [rng.randrange(1 << 30) for _ in range(K + 2 * puts)]
    metrics.reset()
    tracer.reset()
    tmp = tempfile.TemporaryDirectory()
    keys_path = f"{tmp.name}/keys.json"
    cfg = chaos_config(dev, keys_path)
    rec["config"] = {"replicas": len(cfg.replicas.endpoints),
                     "spares": len(cfg.replicas.sentinent),
                     "quorum": cfg.replicas.byz_quorum_size,
                     "f": cfg.replicas.byz_max_faults,
                     "recovery": [cfg.recovery.enabled, cfg.recovery.interval],
                     "anti_entropy": cfg.recovery.anti_entropy_enabled,
                     "admission": cfg.admission.enabled, "audit": cfg.obs.audit_enabled,
                     "request_budget": cfg.proxy.request_budget,
                     "intranet_request_timeout": cfg.proxy.intranet_request_timeout,
                     "chaos_seed": cfg.attacks.chaos_seed}
    step("config", **rec["config"])
    reset_counts()  # path "chaos" starts here
    dep = await launch(cfg)
    port = dep.server.cfg.port
    net = dep.net
    try:
        if not isinstance(net, ChaosNet) or not isinstance(dep.trudy, Nemesis) or \
                not watchtower.attached:
            raise AssertionError("chaos: launch did not wrap the transport in a ChaosNet, "
                                 "arm Nemesis and attach the Watchtower")
        dep.trudy._rng = random.Random(sizes["chaos_seed"])  # the victims, seeded
        # -- the rows: blinding on the card (B3), then PutSet on a clean fabric
        client_be = get_backend("cuda", device=dev.type)
        t = time.perf_counter()
        cts = pk.encrypt_batch(plain, client_be, min_batch=1)
        sync(dev)
        rec["blind"] = {"rows": len(cts), "s": time.perf_counter() - t}
        plain_of.update(zip(cts, plain))
        rec["load"] = await put_rows(cts[:K], "load", sizes["chaos_load_inflight"])
        rec["load"]["putsets_per_s"] = K / rec["load"]["s"]
        step("load", **rec["load"], blind=rec["blind"])
        if net.trace:
            raise AssertionError(f"chaos: the clean fabric injected {trace_counts(net)}")
        steps: dict = {}
        # 1. a clean fabric
        steps["clean"] = summary([await sumall("clean")])
        step("clean", **steps["clean"])
        # 2. seeded link faults on every link
        mark = len(net.trace)
        net.default_faults = LinkFaults(drop=0.02, duplicate=0.02, reorder=0.02,
                                        corrupt=0.01)
        writes = await put_rows(cts[K:K + puts], "link_faults", puts)
        runs = [await sumall("link_faults") for _ in range(sizes["chaos_sumalls"])]
        steps["link_faults"] = {**summary(runs), "puts": writes,
                                "trace": trace_counts(net, mark)}
        net.clear_faults()
        step("link_faults", **steps["link_faults"])
        def nemesis(attack: str) -> list:
            # victims among the replicas active now (proactive recovery
            # rotates them through the spares)
            dep.trudy.replicas = [a for a, _ in dep.supervisor.active]
            return dep.trudy.trigger(attack)

        # 3. Nemesis: delay on f victims
        mark = len(net.trace)
        victims = nemesis("delay")
        runs = [await sumall("delay") for _ in range(sizes["chaos_sumalls"])]
        steps["delay"] = {**summary(runs), "victims": victims,
                          "trace": trace_counts(net, mark)}
        step("delay", **steps["delay"])
        # 4. Nemesis: partition of f victims (a minority)
        mark = len(net.trace)
        victims = nemesis("partition")
        writes = await put_rows(cts[K + puts:], "partition", puts)
        runs = [await sumall("partition") for _ in range(sizes["chaos_sumalls"])]
        steps["partition"] = {**summary(runs), "victims": victims, "puts": writes,
                              "trace": trace_counts(net, mark)}
        step("partition", **steps["partition"])
        # 5. Nemesis: flood
        mark = len(net.trace)
        victims = nemesis("flood")
        runs = [await sumall("flood") for _ in range(sizes["chaos_sumalls"])]
        steps["flood"] = {**summary(runs), "victims": victims,
                          "trace": trace_counts(net, mark)}
        step("flood", **steps["flood"])
        # 6. heal; a quorum-breaking partition under a short budget: all but
        # quorum - 1 replicas cut off (the proxy's view merges every replica
        # ever active, so fewer cuts can leave a quorum); heal
        dep.trudy.trigger("heal")
        budget = dep.server.cfg.request_budget
        keep = [a for a, _ in dep.supervisor.active][:cfg.replicas.byz_quorum_size - 1]
        cut = [e for e in cfg.replicas.endpoints if e not in keep]
        mark = len(net.trace)
        part = net.partition(cut)
        dep.server.cfg.request_budget = sizes["chaos_short_budget"]
        try:
            broken = await sumall("quorum_broken", retry=False)
        finally:
            dep.server.cfg.request_budget = budget
            part.heal()
        dep.trudy.trigger("heal")
        broken = {k: v for k, v in broken.items() if k != "result"}
        broken.update(cut=cut, reachable=keep, budget_s=sizes["chaos_short_budget"],
                      trace=trace_counts(net, mark))
        step("quorum_broken", **broken)
        if broken["status"] != 503 or broken["b1"]:
            raise AssertionError(f"chaos: the quorum-breaking partition's SumAll {broken}")
        healed = await sumall("healed")
        steps["quorum_broken"] = broken
        steps["healed"] = summary([healed])
        step("healed", **steps["healed"])
        # 7. the proxy restarted on the same replicas and snapshot
        old = dep.server
        await old.stop()
        if json.loads(open(keys_path).read()) != sorted(acked):
            raise AssertionError("chaos: the stopped proxy's snapshot is not the "
                                 "acknowledged keys")
        # the same quorum client, as the reference's restart case keeps it:
        # its strikes stand (a fresh one would trust again a replica whose
        # corrupted replies it excluded, which the Watchtower, whose memory
        # outlives the proxy here, reports as suspicion_legality)
        t = time.perf_counter()
        dep.server = DDSRestServer(old.abd, proxy_config(cfg, SUPERVISOR_NAME),
                                   local_replicas=dep.replicas,
                                   slo=SloEngine.from_obs(cfg.obs))
        await dep.server.start()
        port = dep.server.cfg.port
        restart = {"start_s": time.perf_counter() - t,
                   "stored_keys": len(dep.server.stored_keys),
                   "stored_equal_acked": dep.server.stored_keys == set(acked)}
        first = await sumall("restart", deadline_s=CHAOS_RESTART_DEADLINE_S)
        restart.update({k: v for k, v in first.items() if k != "result"},
                       equals_pre_restart=first.get("result") == healed["result"])
        step("restart", **restart)
        if not (restart["stored_equal_acked"] and restart["equals_pre_restart"]):
            raise AssertionError(f"chaos: the restarted proxy {restart}")
        steps["restart"] = restart
        # 8. every acknowledged PutSet read back; the audit
        sem = asyncio.Semaphore(sizes["chaos_read_inflight"])
        wrong, read_retries = [], collections.Counter()

        async def read(k: str) -> None:
            async with sem:
                while True:
                    status, headers, data = await call("GET", f"/GetSet/{k}",
                                                       where="read_back")
                    if status == 200:
                        if json.loads(data)["contents"] != [str(acked[k])]:
                            wrong.append(k)
                        return
                    read_retries[status] += 1
                    await asyncio.sleep(int(headers["retry-after"]))

        t = time.perf_counter()
        await asyncio.gather(*(read(k) for k in sorted(acked)))
        rec["read_back"] = {"rows": len(acked), "wrong": len(wrong),
                            "s": time.perf_counter() - t, "retries": dict(read_retries)}
        step("read_back", **rec["read_back"])
        if wrong:
            raise AssertionError(f"chaos: {len(wrong)} acknowledged rows read back wrong")
        await net.quiesce()
        rec["watchtower"] = watchtower.stats()
        rec["violation_kinds"] = sorted({v.invariant for v in watchtower.verdicts()})
        rec["supervisor"] = {"active": [a for a, _ in dep.supervisor.active],
                             "sentinent": list(dep.supervisor.sentinent)}
        rec["trace"] = trace_counts(net)
        rec["steps"] = steps
    finally:
        await dep.stop()
        tmp.cleanup()
    counts = read_counts(dev)
    rec["launches"] = {"mont_mul": counts["mont_mul"], "mont_exp": counts["mont_exp"]}
    sumall_levels = sum(sum(s["b1"]) for name, s in steps.items()
                        if name not in ("quorum_broken", "restart")) + steps["restart"]["b1"]
    rec["launches"]["mont_mul_sumalls"] = sumall_levels
    rec["statuses"] = {w: dict(collections.Counter(a["status"] for a in answers
                                                  if a["where"] == w))
                       for w in sorted({a["where"] for a in answers})}
    rec["seconds"] = time.perf_counter() - t_phase
    emit("chaos", **{k: rec[k] for k in (
        "seconds", "budget_s", "launches", "load", "blind", "steps", "read_back",
        "trace", "watchtower", "violation_kinds", "supervisor", "statuses")})
    if rec["watchtower"]["ops_audited"] <= 0 or rec["watchtower"]["violations"]:
        raise AssertionError(f"chaos: the Watchtower {rec['watchtower']} "
                             f"{rec['violation_kinds']}")
    if dev.type == "cuda" and (rec["launches"]["mont_exp"] != 1 or
                               rec["launches"]["mont_mul"] != sumall_levels + 2):
        raise AssertionError(f"chaos: B1 {rec['launches']['mont_mul']} launches (SumAlls "
                             f"{sumall_levels} + 2 the blinding's), B3 "
                             f"{rec['launches']['mont_exp']} (1)")
    if watchtower.attached:
        raise AssertionError("chaos: stop left the Watchtower attached")
    return rec


RESHARD_BUDGET_S = 75.0
# configs/sharded.toml's settings the phase overrides (printed); everything
# else stands as the file says
RESHARD_OVERRIDES = {
    "proxy.crypto_backend": "cuda (the file names cpu, the reference's host backend)",
    "proxy.port": "0 (an OS-assigned port for the file's 8443)",
    "fabric.admin_routes": "true: POST /_reshard and POST /_helmsman served",
    "shard.plan_dir": "the reshard plan journal in a temporary directory",
    "helmsman": "enabled, pin = true, interval = 1.0 s, cold-streak = 3, cooldown = 5.0 s "
                "(the rest at the defaults: cold-share 0.1, min-ops 20)",
    "data": "bench_paillier_key(2048): rows of one PSSE column, seeded plaintexts "
            "blinded on the card (B3, one pow_mod for the load and the split's writes)",
    "load.inflight": "8: within the default 250 ms PutSet objective the file leaves",
    "scatter": "the scatter SumAlls run with the proxy's resident min fold set above K, "
               "so they take proxy.scatter_fold instead of the fused resident tree",
}
# the phase's steps, in order (printed)
RESHARD_STEPS = (
    "load K rows by PutSet while Helmsman is pinned: its loop ticks and acts on none",
    "POST /_helmsman {pin: false}; GetSets over keys of s0-s2 only until Helmsman "
    "merges the cold s3 (the deadline printed); POST /_helmsman {pin: true}",
    "SumAlls at S = 3: on the fused resident tree, then scattered",
    "POST /_reshard split s0 -> s3 (the warm standby) while 4 writers PutSet fresh rows "
    "that the split moves to s3; a different plan answers 409 busy, an identical one "
    "attaches, a replay answers the map",
    "SumAlls at S = 4, fused and scattered; every acknowledged row read back; /shards, "
    "the plan directory, /metrics and the Watchtower",
)


async def phase_reshard(dev, sizes) -> dict:
    """configs/sharded.toml served on the card with live resharding and
    Helmsman (RESHARD_OVERRIDES, RESHARD_STEPS printed): 4 groups of 4
    replicas and a spare (quorum 3, f = 1), proactive recovery and
    anti-entropy in each, [resident], the audit. `reshard_K` rows blinded
    on the card (B3; the split's candidate rows in the same pow_mod) and
    loaded by PutSet `reshard_inflight` at a time while Helmsman is pinned
    (at least `reshard_pinned_ticks` ticks, no action; /health's helmsman
    block); unpinned, GetSets spread over the keys of s0, s1 and s2 until
    Helmsman merges s3 by its cold streak (epoch 2, s3 a warm standby whose
    replicas hold none of the moved keys), then pinned again; SumAlls at
    S = 3 through the fused tree and the scatter fold; an operator split of
    s0 onto the standby s3 through POST /_reshard, held behind the
    Rebalancer's lock until a different plan's POST answered 409 busy with
    Retry-After and an identical one was sent, while `reshard_writers`
    writers PutSet `reshard_fresh` rows whose keys the split moves from s0
    to s3 (every write acknowledged; the wrong-shard retries printed); the
    replay answers epoch 3; SumAlls at S = 4, fused and scattered; every
    acknowledged row read back; /shards verifying at epoch 3, the plan
    directory empty, /metrics' dds_helmsman_actions_total{action="merge"}
    1 and dds_reshard_aborts_total as counted, 0 Watchtower violations.
    Every SumAll is the Python-int fold of the acknowledged rows and
    decrypts to their total; on the card its B1 launches are the fused
    tree's levels over the proxy's owner partition (`_owner_memo`, which
    must equal the live map's) or one device fold a group. An aborted
    split (409 aborted, the old map in force) is retried once, counted.
    Launch counts are zeroed before the launch and read after the stop
    (path "reshard"): B1 = the SumAlls' + the blinding's 2, B3 1. Printed:
    each reshape's wall time, moved keys and bytes, each group's pool rows
    after it, the SumAlls' ms, the phase's seconds beside its 75 s
    budget."""
    import os
    import tempfile

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.http.miniserver import http_request_full
    from dds_tpu_torch.models.backend import get_backend
    from dds_tpu_torch.obs.metrics import metrics
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.parallel.mesh import mesh_fold_launches
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.shard import ShardMap
    from dds_tpu_torch.utils import sigs
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    K, fresh = sizes["reshard_K"], sizes["reshard_fresh"]
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    n2 = pk.nsquare
    plan_dir = tempfile.TemporaryDirectory()
    cfg = shard_config(dev, "sharded.toml")
    cfg.fabric.admin_routes = True
    cfg.shard.plan_dir = plan_dir.name
    hcfg = cfg.helmsman
    hcfg.enabled, hcfg.pin, hcfg.interval = True, True, 1.0
    hcfg.cold_streak, hcfg.cooldown = 3, 5.0
    rec: dict = {"overrides": RESHARD_OVERRIDES, "steps": RESHARD_STEPS, "K": K,
                 "fresh": fresh, "key_bits": sizes["key_bits"],
                 "budget_s": RESHARD_BUDGET_S,
                 "users": "operators whose store outgrows, or no longer needs, a quorum "
                          "group reshape it live, by hand or through Helmsman, and still "
                          "get exact aggregates and no lost write",
                 "shard": {k: getattr(cfg.shard, k) for k in (
                     "count", "vnodes_per_group", "replicas_per_group", "sentinent_per_group",
                     "quorum_size", "migrate_chunk_keys", "manifest_timeout", "ack_timeout",
                     "fence_lease")},
                 "helmsman": {k: getattr(hcfg, k) for k in (
                     "interval", "cold_streak", "cold_share", "min_ops", "cooldown", "pin")}}
    answers: list[dict] = []

    def step(name: str, **kw) -> None:
        emit("reshard_step", step=name, at_s=time.perf_counter() - t_phase, **kw)

    def b1() -> int:
        sync(dev)
        return mont_cuda.LAUNCHES["mont_mul"].value

    async def req(method: str, target: str, obj=None, where: str = ""):
        t0 = time.perf_counter()
        status, hdrs, data = await http_request_full(
            "127.0.0.1", port, method, target,
            json.dumps(obj).encode() if obj is not None else None, timeout=600.0)
        answers.append({"where": where, "status": status,
                        "ms": (time.perf_counter() - t0) * 1e3})
        if status == 500:
            raise AssertionError(f"reshard: {method} {target[:40]} at {where} answered 500")
        return status, hdrs, data

    acked: dict[str, int] = {}  # acknowledged key -> ciphertext
    plain_of: dict[int, int] = {}

    async def put_rows(cts: list, where: str, inflight: int) -> dict:
        sem = asyncio.Semaphore(inflight)
        retries = collections.Counter()

        async def put(c) -> None:
            async with sem:
                while True:
                    status, hdrs, data = await req("POST", "/PutSet",
                                                   {"contents": [str(c)]}, where)
                    if status == 200:
                        acked[data.decode()] = c
                        return
                    if status not in (429, 503) or int(hdrs.get("retry-after", 0)) < 1:
                        raise AssertionError(f"reshard: a PutSet at {where} answered "
                                             f"{status} {hdrs}")
                    retries[status] += 1  # a client honouring Retry-After
                    await asyncio.sleep(int(hdrs["retry-after"]))

        t = time.perf_counter()
        await asyncio.gather(*(put(c) for c in cts))
        return {"rows": len(cts), "s": time.perf_counter() - t, "retries": dict(retries)}

    def partition() -> dict[str, list]:
        return const.router.partition_keys(sorted(acked))

    async def sumalls(label: str) -> dict:
        """`reshard_sumalls` SumAlls on the fused tree, then as many through
        the scatter fold: each the fold of the acknowledged rows, with its
        B1 launches against the owner partition it folded over."""
        want = host_product(list(acked.values()), n2)
        total = sum(plain_of[c] for c in acked.values())
        live = {g: len(v) for g, v in sorted(partition().items())}
        out = {"groups": live}
        min_fold = server._resident_min_fold
        for route in ("resident", "scatter"):
            if route == "scatter":
                server._resident_min_fold = len(acked) + 1
            tracer.reset()
            ms, launched = [], []
            try:
                for _ in range(sizes["reshard_sumalls"]):
                    before = b1()
                    t0 = time.perf_counter()
                    status, _, data = await req("GET", f"/SumAll?position=0&nsqr={n2}",
                                                where=f"{label}_{route}")
                    ms.append((time.perf_counter() - t0) * 1e3)
                    launched.append(b1() - before)
                    result = int(json.loads(data)["result"]) if status == 200 else None
                    if result != want or key.decrypt(result) != total:
                        raise AssertionError(f"reshard: a {label} {route} SumAll answered "
                                             f"{status}, not the fold of the "
                                             f"{len(acked)} acknowledged rows")
            finally:
                server._resident_min_fold = min_fold
            spans = tracer.summary()
            memo = {g: len(ops) for g, ops in server._owner_memo[2]}
            sizes_ = [memo[g] for g in sorted(memo)]
            expected = (mesh_fold_launches([sizes_]) if route == "resident"
                        else sum(mont_cuda.fold_launches(k) for k in sizes_))
            span = "proxy.resident_fold" if route == "resident" else "proxy.scatter_fold"
            out[route] = {"ms": ms, "p50_ms": pct(ms, 50), "b1": launched,
                          "b1_expected": expected, "memo_groups": memo,
                          "folds": spans.get(span, {}).get("count", 0),
                          "fold_mean_ms": spans.get(span, {}).get("mean_ms")}
            if out[route]["folds"] != len(ms):
                raise AssertionError(f"reshard: the {label} SumAlls did not take {span}: "
                                     f"{sorted(spans)}")
            if memo != live:
                raise AssertionError(f"reshard: the {label} SumAlls folded over the owner "
                                     f"partition {memo}, not the live map's {live}")
            if dev.type == "cuda" and route == "scatter" and \
                    min(sizes_) < server.backend.min_device_batch:
                raise AssertionError(f"reshard: a group below the device crossover {memo}")
            if dev.type == "cuda" and any(n != expected for n in launched):
                raise AssertionError(f"reshard: a {label} {route} SumAll launched "
                                     f"{launched} mont_mul, not {expected}")
        out["pool_rows"] = pool_rows()
        step(f"sumall_{label}", **out)
        return out

    def pool_rows() -> dict:
        return {gid: p.resident for (gid, _, mod), p in sorted(server._resident._pools.items())
                if mod == n2}

    metrics.reset()
    tracer.reset()
    step("config", **{k: v for k, v in rec.items() if k not in ("overrides", "steps")})
    reset_counts()  # path "reshard" starts here
    t = time.perf_counter()
    dep = await launch(cfg)
    rec["launch_s"] = time.perf_counter() - t
    server = dep.server
    port = server.cfg.port
    const = dep.constellation
    hm = server.helmsman
    sumall_b1 = 0
    try:
        if const is None or hm is None or server._reshard is None or \
                not server.cfg.reshard_route_enabled or not watchtower.attached:
            raise AssertionError("reshard: launch did not bring up the Constellation, its "
                                 "reshard route, Helmsman and the audit")
        # -- the rows: one blinding on the card (B3), then PutSet while pinned
        rng = random.Random(sizes["reshard_seed"])
        n_cand = sizes["reshard_candidates"]
        plain = [rng.randrange(1 << 30) for _ in range(K + n_cand)]
        client_be = get_backend("cuda", device=dev.type)
        t = time.perf_counter()
        cts = pk.encrypt_batch(plain, client_be, min_batch=1)
        sync(dev)
        rec["blind"] = {"rows": len(cts), "s": time.perf_counter() - t}
        plain_of.update(zip(cts, plain))
        rec["load"] = await put_rows(cts[:K], "load", sizes["reshard_inflight"])
        rec["load"]["putsets_per_s"] = K / rec["load"]["s"]
        deadline = time.perf_counter() + 30.0
        while hm.ticks < sizes["reshard_pinned_ticks"] and time.perf_counter() < deadline:
            await asyncio.sleep(0.1)
        _, _, hdata = await req("GET", "/health", where="pinned")
        hblock = json.loads(hdata).get("helmsman", {})
        rec["pinned"] = {"ticks": hm.ticks, "health_pinned": hblock.get("pinned"),
                         "health_ticks": hblock.get("ticks"), "actions": list(hm.history),
                         "keys_per_group": {g: len(v) for g, v in sorted(partition().items())}}
        step("load", **rec["load"], blind=rec["blind"], pinned=rec["pinned"])
        if hm.ticks < sizes["reshard_pinned_ticks"] or hm.history or \
                hblock.get("pinned") is not True or not hblock.get("ticks"):
            raise AssertionError(f"reshard: the pinned Helmsman {rec['pinned']}")
        # -- Helmsman merges the cold group once unpinned
        old = const.manager.current()
        cold = "s3"
        hot_keys = {g: [k for k in sorted(acked) if old.owner(k) == g] for g in old.groups}
        moved = set(hot_keys.pop(cold))
        spread = [k for trio in zip(*hot_keys.values()) for k in trio]
        signals = {"slo_alerts": server.slo.alerts(),
                   "shed_level": server.admission.shed_level if server.admission else 0,
                   "open_breakers": len(const.router.breaker_census()[1])}
        step("before_unpin", **signals)
        if signals["slo_alerts"] or signals["shed_level"]:
            raise AssertionError(f"reshard: the fleet is distressed before the merge: "
                                 f"{signals}")
        status, _, data = await req("POST", "/_helmsman", {"pin": False}, "unpin")
        if status != 200 or json.loads(data)["pinned"]:
            raise AssertionError(f"reshard: POST /_helmsman unpin answered {status}")
        t_unpin = time.perf_counter()
        merged = asyncio.Event()
        gets = collections.Counter()

        async def getter(i: int) -> None:
            j = i
            while not merged.is_set():
                k = spread[j % len(spread)]
                j += sizes["reshard_inflight"]
                status, _, data = await req("GET", f"/GetSet/{k}", where="merge_gets")
                if status != 200 or json.loads(data)["contents"] != [str(acked[k])]:
                    raise AssertionError(f"reshard: a GetSet during the merge answered "
                                         f"{status}")
                gets[const.router.owner(k)] += 1

        async def watch() -> None:
            try:
                while cold not in [g.gid for g in const.standbys]:
                    if time.perf_counter() - t_unpin > sizes["reshard_merge_deadline_s"]:
                        raise AssertionError(
                            f"reshard: Helmsman did not merge {cold} within "
                            f"{sizes['reshard_merge_deadline_s']} s: {list(hm.history)}, "
                            f"{hm.report()}")
                    await asyncio.sleep(0.05)
            finally:
                merged.set()

        await asyncio.gather(watch(), *(getter(i) for i in range(sizes["reshard_inflight"])))
        merge_s = time.perf_counter() - t_unpin
        status, _, data = await req("POST", "/_helmsman", {"pin": True}, "repin")
        if status != 200 or not json.loads(data)["pinned"]:
            raise AssertionError(f"reshard: POST /_helmsman pin answered {status}")
        notes = {r["action"]: r for r in hm.history}
        victim = next(g for g in const.standbys if g.gid == cold)
        still_held = sum(1 for n in victim.replicas.values() for k in moved
                         if n.repository.get(k, (None, None))[1] is not None)
        rec["merge"] = {"unpin_to_merged_s": merge_s,
                        "deadline_s": sizes["reshard_merge_deadline_s"],
                        "ticks": hm.ticks, "gets": dict(gets),
                        "wall_s": notes["merge_done"]["t"] - notes["merge"]["t"]
                        if "merge_done" in notes else None,
                        "decision": notes.get("merge"),
                        "moved_keys": const.rebalancer.last_moved_keys,
                        "moved_bytes": const.rebalancer.last_moved_bytes,
                        "epoch": const.manager.epoch, "groups": const.gids,
                        "standbys": [g.gid for g in const.standbys],
                        "victim_keys_held": still_held, "pool_rows": pool_rows()}
        step("merge", **rec["merge"])
        if const.manager.epoch != 2 or const.gids != ["s0", "s1", "s2"] or still_held or \
                "merge_done" not in notes or any(r["action"] not in (
                    "unpin", "pin", "merge", "merge_done") for r in hm.history):
            raise AssertionError(f"reshard: the merge {rec['merge']}, {list(hm.history)}")
        # -- SumAlls at S = 3
        rec["sumall_s3"] = await sumalls("s3")
        sumall_b1 += sum(sum(rec["sumall_s3"][r]["b1"]) for r in ("resident", "scatter"))
        # -- the operator's split onto the warm standby, writers in flight
        split_map = const.manager.current().split("s0", cold)
        cur = const.manager.current()
        movers = [c for c in cts[K:] if cur.owner(sigs.key_from_set([str(c)])) == "s0"
                  and split_map.owner(sigs.key_from_set([str(c)])) == cold][:fresh]
        if len(movers) < fresh:
            raise AssertionError(f"reshard: {len(movers)} of {n_cand} candidate rows move "
                                 f"s0 -> {cold}, not {fresh}")
        body = {"action": "split", "source": "s0", "target": cold}
        lock = const.rebalancer.lock
        split_tries = collections.Counter()
        fenced_before = collections.Counter(family("dds_wrong_shard_retries_total"))
        await lock.acquire()  # the plan queues behind the controller's lock
        held = True
        try:
            first = asyncio.ensure_future(req("POST", "/_reshard", body, "split"))
            while server._reshard_inflight is None:
                await asyncio.sleep(0.005)
            bst, bhdrs, bdata = await req("POST", "/_reshard",
                                          {"action": "merge", "source": "s1"}, "busy")
            second = asyncio.ensure_future(req("POST", "/_reshard", body, "split_attach"))
            await asyncio.sleep(0.5)  # the identical request reaches the route and attaches
            per = -(-fresh // sizes["reshard_writers"])
            writers = asyncio.ensure_future(asyncio.gather(*(
                put_rows(movers[i * per:(i + 1) * per], "split_writes", 1)
                for i in range(sizes["reshard_writers"]))))
            t_split = time.perf_counter()  # the plan runs from here
            lock.release()
            held = False
            (s1, _, d1), (s2, _, d2) = await asyncio.gather(first, second)
            split_s = time.perf_counter() - t_split
            writes = await writers
            if s1 == 409 and "aborted" in json.loads(d1):
                split_tries["aborted"] += 1  # the old map is in force: retry once
                step("split_aborted", answer=json.loads(d1))
                s1, _, d1 = await req("POST", "/_reshard", body, "split_retry")
                s2, d2 = s1, d1
        finally:
            if held:
                lock.release()
        rst, _, rdata = await req("POST", "/_reshard", body, "replay")
        rec["split"] = {"answer": [s1, json.loads(d1)], "attached": [s2, json.loads(d2)],
                        "busy": [bst, json.loads(bdata), bhdrs.get("retry-after")],
                        "replay": [rst, json.loads(rdata)], "wall_s": split_s,
                        "aborts_retried": dict(split_tries),
                        "moved_keys": const.rebalancer.last_moved_keys,
                        "moved_bytes": const.rebalancer.last_moved_bytes,
                        "moved_bytes_total": const.rebalancer.moved_bytes_total,
                        "writes": {"rows": len(movers),
                                   "retries": dict(sum((collections.Counter(w["retries"])
                                                        for w in writes),
                                                       collections.Counter())),
                                   "s": max(w["s"] for w in writes)},
                        "wrong_shard_retries": {
                            dict(k).get("shard", "-"): v - fenced_before[k]
                            for k, v in family("dds_wrong_shard_retries_total").items()
                            if v != fenced_before[k]},
                        "epoch": const.manager.epoch, "groups": const.gids,
                        "standbys": [g.gid for g in const.standbys],
                        "pool_rows": pool_rows()}
        step("split", **rec["split"])
        if (s1, s2, bst, rst) != (200, 200, 409, 200) or json.loads(d1) != json.loads(d2) \
                or "idempotent" in json.loads(d1) or json.loads(d1)["epoch"] != 3 or \
                json.loads(bdata).get("busy", {}).get("action") != "split" or \
                int(bhdrs.get("retry-after", 0)) < 1 or \
                not json.loads(rdata).get("idempotent") or json.loads(rdata)["epoch"] != 3 \
                or const.manager.epoch != 3 or const.standbys or \
                sorted(const.gids) != ["s0", "s1", "s2", "s3"] or split_tries["aborted"] > 1:
            raise AssertionError(f"reshard: the operator split {rec['split']}")
        if any(cur.owner(k) == "s0" and split_map.owner(k) == cold
               and const.router.owner(k) != cold for k in acked):
            raise AssertionError("reshard: a moved key is not owned by the split's target")
        # -- SumAlls at S = 4; every acknowledged row read back; the surfaces
        rec["sumall_s4"] = await sumalls("s4")
        sumall_b1 += sum(sum(rec["sumall_s4"][r]["b1"]) for r in ("resident", "scatter"))
        sem = asyncio.Semaphore(sizes["reshard_read_inflight"])
        wrong = []

        async def read(k: str) -> None:
            async with sem:
                status, _, data = await req("GET", f"/GetSet/{k}", where="read_back")
                if status != 200 or json.loads(data)["contents"] != [str(acked[k])]:
                    wrong.append(k)

        t = time.perf_counter()
        await asyncio.gather(*(read(k) for k in sorted(acked)))
        rec["read_back"] = {"rows": len(acked), "wrong": len(wrong),
                            "s": time.perf_counter() - t}
        sst, _, sdata = await req("GET", "/shards", where="shards")
        smap = ShardMap.from_wire(json.loads(sdata)["map"])
        _, _, mdata = await req("GET", "/metrics", where="metrics")
        series = sorted(ln for ln in mdata.decode().splitlines()
                        if ln.startswith(("dds_helmsman_actions_total", "dds_reshard_",
                                          "dds_wrong_shard_retries_total", "dds_shard_epoch")))
        await dep.net.quiesce()
        rec["surfaces"] = {
            "shards": sst, "shards_epoch": smap.epoch,
            "shards_verify": smap.verify(cfg.security.abd_mac_secret.encode()),
            "plan_dir": sorted(os.listdir(plan_dir.name)),
            "helmsman_merges": metrics.value("dds_helmsman_actions_total", action="merge"),
            "reshard_aborts": metrics.value("dds_reshard_aborts_total") or 0,
            "series": series, "watchtower": watchtower.stats(),
            "violation_kinds": sorted({v.invariant for v in watchtower.verdicts()})}
        step("surfaces", read_back=rec["read_back"], **rec["surfaces"])
        surf = rec["surfaces"]
        if wrong or (sst, surf["shards_epoch"], surf["shards_verify"]) != (200, 3, True) or \
                surf["plan_dir"] or surf["helmsman_merges"] != 1 or \
                surf["reshard_aborts"] != split_tries["aborted"] or \
                surf["watchtower"]["ops_audited"] <= 0 or surf["watchtower"]["violations"]:
            raise AssertionError(f"reshard: {len(wrong)} rows read back wrong; the surfaces "
                                 f"{surf}")
    finally:
        await dep.stop()
        plan_dir.cleanup()
    counts = read_counts(dev)
    rec["launches"] = {"mont_mul": counts["mont_mul"], "mont_exp": counts["mont_exp"],
                       "mont_mul_sumalls": sumall_b1}
    rec["statuses"] = {w: dict(collections.Counter(a["status"] for a in answers
                                                  if a["where"] == w))
                       for w in sorted({a["where"] for a in answers})}
    rec["seconds"] = time.perf_counter() - t_phase
    emit("reshard", **{k: rec[k] for k in (
        "seconds", "budget_s", "launch_s", "launches", "load", "blind", "pinned", "merge",
        "sumall_s3", "split", "sumall_s4", "read_back", "surfaces", "statuses")})
    if dev.type == "cuda" and (rec["launches"]["mont_exp"] != 1 or
                               rec["launches"]["mont_mul"] != sumall_b1 + 2):
        raise AssertionError(f"reshard: B1 {rec['launches']['mont_mul']} launches (SumAlls "
                             f"{sumall_b1} + 2 the blinding's), B3 "
                             f"{rec['launches']['mont_exp']} (1)")
    if watchtower.attached:
        raise AssertionError("reshard: stop left the Watchtower attached")
    return rec


MESH_BUDGET_S = 45.0
# the settings the mesh phase's served SumAll overrides (printed); the rest
# is DDSConfig() as the earlier phases build it (EARLIER_OBS_CUTS)
MESH_OVERRIDES = {
    "config": "configs/sharded.toml with SHARDED_OVERRIDES' backend and port, and "
              "min-device-batch 0",
    "backend.mesh": "the server's backend built with Mesh([cuda:0] * 4) (the proxy's backend "
                    "factory wrapped during launch, so the resident plane is built on the "
                    "mesh): no config key names a mesh (the reference takes it by mesh= or "
                    "DDS_MESH, and DDS_MESH truncates to the one card)",
    "data": "bench_paillier_key(2048): rows of one PSSE column, seeded plaintexts under 64 "
            "seeded host blinds, 64 PutSets in flight",
}


def tail_products(D: int) -> int:
    """Products of the tail tree over D partials, each odd level padded."""
    p = 0
    while D > 1:
        D += D % 2
        p += D // 2
        D //= 2
    return p


def mesh_times(fn, dev, reps: int) -> dict:
    """{device_ms, dispatch_ms, wall_ms} a call of `fn`: device and
    dispatch ms with the stream held (`held_ms`), wall ms the best of
    `reps` calls each synchronised."""
    dms, dispatch = held_ms(fn, reps, dev)
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync(dev)
        walls.append((time.perf_counter() - t) * 1e3)
    return {"device_ms": dms, "dispatch_ms": dispatch, "wall_ms": min(walls)}


async def phase_mesh(dev, sizes) -> dict:
    """The device mesh (`parallel/mesh`, the reference's
    `dds_tpu/parallel/mesh.py` and the resident plane's multi-device
    fold) at Paillier-2048's n^2 (L = 256), on `Mesh([dev] * D)`: D slots
    on the one card, each copy between slots an explicit `.to()`.
    - `sharded_reduce_mul_fixed` over `mesh_K` and `mesh_K - 1` seeded rows
      for D in `mesh_D`, both combines (all_gather, ring), mode 0; at the
      largest D also modes 1 and 2: each bit for bit the flat
      `mont_cuda.reduce_mul` and the Python-int product, its launches the
      formula `mesh_fold_launches` (D local trees of log2(P2) levels,
      then ceil(log2 D) tail levels or D(D - 1) ring multiplies, then the
      fix: 47 and 57 at K = 8,192, D = 4);
    - `sharded_pow_mod` over `mesh_B` bases with the key's n as exponent
      (E = 512 digits) at D = 4: bit for bit the flat `pow_mod`, 64 sampled
      columns Python `pow`, 2D B1 and D B3 launches; then
      `CudaBackend.powmod_batch` with that mesh over `mesh_B_backend` bases
      (padded with base 1 to a multiple of D);
    - `CudaBackend(mesh=...).modmul_fold_resident` over `mesh_K` ints;
    - the resident plane with `mesh_plane_S` groups of `mesh_plane_rows`:
      for D in `mesh_plane_D`, each group's rows folded on its pool's slot
      (`mesh_fold_launches`: 25 at D = 2, 47 at D = 4, 36 at D = 3, where
      slot 0 holds groups 0 and 3), the Python product, timed beside the
      same slabs on one slot (14);
    - SumAlls served by configs/sharded.toml's 4 groups (4 replicas and a
      spare each, quorum 3, f = 1, [resident]) on the card, the server's
      backend built with the 4-slot mesh (MESH_OVERRIDES), so the plane
      places group i's pool on slot i: `mesh_sumall_K` rows by PutSet
      (DEPTH_CUTS), then `mesh_sumalls` SumAlls, each through the plane's
      fold (`proxy.resident_fold`), the Python fold, decrypting to the
      total, with one local tree a slot, the tail and the fix;
    - DDS_MESH=4 on a backend of its own: `make_mesh` truncates to the
      cards that exist (1 here), so `mesh_devices` is 1 and a fold takes
      the flat path's launches.
    Counts are zeroed just before and read just after each gated call;
    the flat calls it is compared with are not counted. Each call's
    device, dispatch and wall ms beside the flat call's, and the bound of
    its products (the flat path's work plus the combine's). Printed: the
    phase's seconds beside its 45 s budget."""
    import os

    import torch
    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.models.backend import CudaBackend
    from dds_tpu_torch.ops import bignum as bn
    from dds_tpu_torch.ops import mont_cuda
    from dds_tpu_torch.ops.montgomery import ModCtx, _exp_to_digits
    from dds_tpu_torch.http import server as server_mod
    from dds_tpu_torch.parallel import mesh as pm
    from dds_tpu_torch.parallel.mesh import mesh_fold, mesh_fold_launches
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.trace import tracer

    t_phase = time.perf_counter()
    key = bench_paillier_key(sizes["key_bits"])
    pk = key.public
    n2 = pk.nsquare
    ctx = ModCtx.make(n2)
    card = card_numbers(dev)
    reps, seed = sizes["mesh_reps"], sizes["mesh_seed"]
    cuda = dev.type == "cuda"
    per_product = (2 * ctx.W * ctx.W + ctx.W) * 2  # IMADs of one CIOS product

    def bound(products: float, nbytes: float) -> dict:
        bms, by = bound_ms(products * per_product, nbytes, card["sms"], card["clock_mhz"])
        return {"products": products, "bound_ms": bms, "bound_by": by}

    def gate_launches(counts: dict, want: dict, what: str) -> None:
        got = {k: counts[k] for k in want}
        if cuda and got != want:
            raise AssertionError(f"mesh {what}: launches {got}, predicted {want}")

    path = collections.Counter()  # the mesh path's launches, each call zeroed and read apart
    rec: dict = {"L": ctx.L, "budget_s": MESH_BUDGET_S, "overrides": MESH_OVERRIDES,
                 "users": "operators with more than one GPU in the proxy's host, who set "
                          "DDS_MESH or pass a mesh to the backend",
                 "folds": [], "modes": {}}
    saved = {k: os.environ.get(k) for k in ("DDS_KARATSUBA", "DDS_MESH")}
    os.environ["DDS_KARATSUBA"] = "0"
    os.environ.pop("DDS_MESH", None)
    try:
        # -- the sharded fold, both combines, against the flat fold and Python
        D_max = max(sizes["mesh_D"])
        for K in (sizes["mesh_K"], sizes["mesh_K"] - 1):
            host = residues(ctx, K, seed + K)
            want = host_product(bn.batch_to_ints(host), n2)
            rows = bn.to_device(host, dev)
            flat = mont_cuda.reduce_mul(ctx, rows, karatsuba=False)
            if bn.limbs_to_int(bn.to_host(flat)[0]) != want:
                raise AssertionError(f"mesh: the flat K={K} fold != Python")
            flat_t = mesh_times(lambda: mont_cuda.reduce_mul(ctx, rows, karatsuba=False),
                                dev, reps)
            P2 = 1 << max(1, (K - 1).bit_length())
            cases = [(D, ring, "cios") for D in sizes["mesh_D"] for ring in (False, True)]
            cases += [(D_max, False, "k1"), (D_max, False, "fused")]
            for D, ring, kernel in cases:
                mesh = pm.Mesh([dev] * D)
                fn = lambda: pm.sharded_reduce_mul_fixed(ctx, rows, mesh, ring, kernel)  # noqa: E731
                reset_counts()  # this call's run starts here
                out = fn()
                counts = read_counts(dev)
                if not torch.equal(out, flat) or bn.limbs_to_int(bn.to_host(out)[0]) != want:
                    raise AssertionError(f"mesh: sharded K={K} D={D} ring={ring} {kernel} != "
                                         f"the flat fold and Python")
                n_mul = mesh_fold_launches([[-(-K // D)]] * D, ring)
                main = {"cios": "mont_mul", "k1": "mont_prod3", "fused": "mont_kfused"}[kernel]
                gate_launches(counts, {main: n_mul}, f"K={K} D={D} ring={ring} {kernel}")
                mode = {"cios": "0", "k1": "1", "fused": "2"}[kernel]
                check_mode_launches(dev, counts, mode, f"mesh K={K} D={D}")
                path.update({k: v for k, v in counts.items() if v})
                shard_P2 = 1 << max(0, (-(-K // D) - 1).bit_length())
                combine = D * (D - 1) if ring else tail_products(D)
                cell = {"K": K, "D": D, "ring": ring, "kernel": kernel, "launches": n_mul,
                        "launch_counts": {k: v for k, v in counts.items() if v},
                        **bound(D * (shard_P2 - 1) + combine + 1, (K + 1) * ctx.L * 4),
                        **mesh_times(fn, dev, reps),
                        "flat": {"launches": mont_cuda.fold_launches(K),
                                 **bound(P2, (K + 1) * ctx.L * 4), **flat_t}}
                if kernel != "cios":
                    rec["modes"].setdefault(mode, collections.Counter()).update(
                        cell["launch_counts"])
                rec["folds"].append(cell)
                emit("mesh", what="fold", **cell)
        rec["modes"] = {m: {"launches": {k: c[k] for k in FOLD_KERNELS}}
                        for m, c in rec["modes"].items()}

        # -- the sharded modexp, then the backend's padded batch
        B, D = sizes["mesh_B"], D_max
        mesh = pm.Mesh([dev] * D)
        bases = residues(ctx, B, seed + 1)
        bases_dev = bn.to_device(bases, dev)
        exp = pk.n
        flat = mont_cuda.pow_mod(ctx, bases_dev, exp, karatsuba=False)
        fn = lambda: pm.sharded_pow_mod(ctx, bases_dev, exp, mesh, "cios")  # noqa: E731
        reset_counts()
        out = fn()
        counts = read_counts(dev)
        if not torch.equal(out, flat):
            raise AssertionError(f"mesh: sharded pow_mod B={B} D={D} != the flat pow_mod")
        gate_launches(counts, {"mont_mul": 2 * D, "mont_exp": D}, f"pow_mod B={B} D={D}")
        path.update({k: v for k, v in counts.items() if v})
        got = bn.batch_to_ints(bn.to_host(out))
        sample = random.Random(seed).sample(range(B), sizes["mesh_pow_check"])
        ints = bn.batch_to_ints(bases)
        t = time.perf_counter()
        if any(got[i] != pow(ints[i], exp, n2) for i in sample):
            raise AssertionError("mesh: sharded pow_mod != Python pow")
        py_ms = (time.perf_counter() - t) * 1e3 / len(sample)
        E = len(_exp_to_digits(exp))
        per_row = 5 * E + 16
        rec["pow"] = {"B": B, "D": D, "E": E, "launches": {"mont_mul": 2 * D, "mont_exp": D},
                      **bound(B * per_row, 2 * B * ctx.L * 4),
                      **mesh_times(fn, dev, 1),
                      "flat": mesh_times(lambda: mont_cuda.pow_mod(ctx, bases_dev, exp,
                                                                  karatsuba=False), dev, 1),
                      "python_pow_ms_a_row": py_ms, "python_checked": len(sample)}
        be = CudaBackend(device=dev, mesh=mesh)
        Bb = sizes["mesh_B_backend"]
        reset_counts()
        t = time.perf_counter()
        via = be.powmod_batch(ints[:Bb], exp, n2)
        backend_s = time.perf_counter() - t
        counts = read_counts(dev)
        if via != got[:Bb]:
            raise AssertionError(f"mesh: powmod_batch B={Bb} over {D} slots != the sharded pow")
        gate_launches(counts, {"mont_mul": 2 * D, "mont_exp": D}, f"powmod_batch B={Bb}")
        path.update({k: v for k, v in counts.items() if v})
        rec["pow"]["backend"] = {"B": Bb, "padded": -(-Bb // D) * D, "wall_s": backend_s}
        emit("mesh", what="pow", **rec["pow"])

        # -- the backend's resident fold over K ints through the mesh
        K = sizes["mesh_K"]
        host = residues(ctx, K, seed + 2)
        ints = bn.batch_to_ints(host)
        want = host_product(ints, n2)
        be.modmul_fold_resident(ints, n2)  # ingest
        reset_counts()
        t = time.perf_counter()
        if be.modmul_fold_resident(ints, n2) != want:
            raise AssertionError("mesh: modmul_fold_resident over the mesh != Python")
        resident_s = time.perf_counter() - t
        counts = read_counts(dev)
        n_mul = mesh_fold_launches([[-(-K // D)]] * D)
        gate_launches(counts, {"mont_mul": n_mul}, f"modmul_fold_resident K={K}")
        path.update({k: v for k, v in counts.items() if v})
        rec["backend_fold"] = {"K": K, "D": D, "launches": n_mul, "wall_ms": resident_s * 1e3}
        emit("mesh", what="backend_fold", **rec["backend_fold"])

        # -- the resident plane: each group's rows folded on its pool's slot
        S, G = sizes["mesh_plane_S"], sizes["mesh_plane_rows"]
        ops = seeded_ints(ctx, S * G, seed + 3)
        parts = split(ops, S)
        want = host_product(ops, n2)
        rec["plane"] = []
        for D in sizes["mesh_plane_D"]:
            mesh = pm.Mesh([dev] * D)
            plane = CudaBackend(device=dev, min_device_batch=0, mesh=mesh).resident_plane(
                sizes["resident_initial"], sizes["resident_max"])
            if plane.fold_groups(parts, n2) != want:  # ingest
                raise AssertionError(f"mesh: plane S={S} D={D} != Python")
            reset_counts()
            t = time.perf_counter()
            if plane.fold_groups(parts, n2) != want:
                raise AssertionError(f"mesh: plane S={S} D={D} != Python")
            wall = (time.perf_counter() - t) * 1e3
            counts = read_counts(dev)
            slots = [[plane.pool(g, n2).rows_for(o) for g, o in parts
                      if plane._order[g] % D == d] for d in range(D)]
            n_mul = mesh_fold_launches([[s.shape[0] for s in slabs] for slabs in slots])
            gate_launches(counts, {"mont_mul": n_mul}, f"plane S={S} D={D}")
            path.update({k: v for k, v in counts.items() if v})
            if plane.stats()["mesh_devices"] != D:
                raise AssertionError(f"mesh: the plane reports {plane.stats()['mesh_devices']}")
            slabs = [s for slot in slots for s in slot]
            P2 = 1 << max(0, (G - 1).bit_length())
            cell = {"S": S, "rows_a_group": G, "D": D,
                    "groups_by_slot": [len(slot) for slot in slots], "launches": n_mul,
                    "fold_groups_wall_ms": wall,
                    **bound(S * (P2 - 1) + tail_products(S) + 1, (S * G + 1) * ctx.L * 4),
                    **mesh_times(lambda: mesh_fold(ctx, slots, dev, False), dev, reps),
                    "one_device": mesh_times(lambda: mesh_fold(ctx, [slabs], dev, False),
                                             dev, reps)}
            rec["plane"].append(cell)
            emit("mesh", what="plane", **cell)
            del plane, slots, slabs

        # -- SumAlls served by sharded.toml's 4 groups, the backend built with
        # a 4-slot mesh, so the resident plane places group i's pool on slot i
        K, D = sizes["mesh_sumall_K"], D_max
        rows, total = paillier_rows(pk, K, seed + 4)
        cfg = shard_config(dev, "sharded.toml")
        cfg.proxy.min_device_batch = 0
        served_mesh = pm.Mesh([dev] * D)
        make_backend = server_mod._make_backend
        server_mod._make_backend = lambda pcfg: CudaBackend(  # MESH_OVERRIDES
            device=pcfg.device, min_device_batch=pcfg.min_device_batch, mesh=served_mesh)
        try:
            dep = await launch(cfg)
        finally:
            server_mod._make_backend = make_backend
        try:
            server = dep.server
            plane = server._resident
            if plane is None or plane.mesh is not served_mesh or server._shards is None:
                raise AssertionError("mesh: the served stack's plane was not built on the "
                                     "4-slot mesh over the shard groups")
            port = server.cfg.port
            load_s = await put_rows(port, rows)
            sumall = sumall_fn(port, n2)
            want = host_product([r[PSSE_POS] for r in rows], n2)
            tracer.reset()
            reset_counts()  # the served SumAlls' run starts here
            ms = []
            for _ in range(sizes["mesh_sumalls"]):
                t = time.perf_counter()
                got = await sumall()
                ms.append((time.perf_counter() - t) * 1e3)
                if got != want or key.decrypt(got) != total:
                    raise AssertionError("mesh: a served SumAll != the Python fold or total")
            counts = read_counts(dev)
            folds = tracer.summary().get("proxy.resident_fold", {}).get("count", 0)
            memo = {g: len(ops) for g, ops in server._owner_memo[2]}
            slot_of = {g: plane._order[g] % D for g in memo}
            placed = {g: str(p.device) for (g, _, _), p in plane._pools.items()}
        finally:
            await dep.stop()
        by_slot = [[memo[g] for g in sorted(memo) if slot_of[g] == d] for d in range(D)]
        n_mul = sizes["mesh_sumalls"] * mesh_fold_launches(by_slot)
        gate_launches(counts, {"mont_mul": n_mul}, "served SumAlls")
        if folds != sizes["mesh_sumalls"] or sorted(slot_of.values()) != list(range(D)):
            raise AssertionError(f"mesh: the served SumAlls took {folds} resident folds, "
                                 f"groups on slots {slot_of}")
        rec["sumall"] = {"K": K, "D": D, "config": "sharded.toml",
                         "groups": len(memo), "rows_by_slot": by_slot, "slot_of": slot_of,
                         "pool_devices": placed, "resident_folds": folds, "load_s": load_s,
                         "sumall_ms": ms, "launches": counts["mont_mul"],
                         "launches_predicted": n_mul}
        emit("mesh", what="sumall", **rec["sumall"])

        # -- DDS_MESH=4 on the card: truncated to the cards that exist
        os.environ["DDS_MESH"] = "4"
        be = CudaBackend(device=dev, min_device_batch=0)
        K = sizes["mesh_K"]
        host = residues(ctx, K, seed + 5)
        ints = bn.batch_to_ints(host)
        reset_counts()
        if be.modmul_fold(ints, n2) != host_product(ints, n2):
            raise AssertionError("mesh: the DDS_MESH=4 fold != Python")
        counts = read_counts(dev)
        exists = torch.cuda.device_count() if cuda else 1
        n_mul = (mont_cuda.fold_launches(K) if min(4, exists) == 1
                 else mesh_fold_launches([[-(-K // min(4, exists))]] * min(4, exists)))
        gate_launches(counts, {"mont_mul": n_mul}, "DDS_MESH=4")
        devices = be.resident_plane().stats()["mesh_devices"]
        if be.mesh.size != min(4, exists) or devices != be.mesh.size:
            raise AssertionError(f"mesh: DDS_MESH=4 built {be.mesh} on {exists} devices, the "
                                 f"plane reports {devices}")
        rec["dds_mesh"] = {"DDS_MESH": 4, "devices_that_exist": exists,
                           "mesh_devices": devices, "launches": counts["mont_mul"]}
        emit("mesh", what="dds_mesh", **rec["dds_mesh"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec["launches"] = {k: path[k] for k in mont_cuda.LAUNCHES}
    rec["seconds"] = time.perf_counter() - t_phase
    emit("mesh", what="summary", seconds=rec["seconds"], budget_s=MESH_BUDGET_S,
         launches=rec["launches"], modes=rec["modes"])
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


def phases_alone(names: list[str], sizes: dict) -> int:
    """The named phases in this process on the card, after the kernels'
    build and with Chronoscope off (as `main` runs them), each followed
    by one {"phase": "alone", "name", "seconds", "sizes"} line; then the
    card's name and power limit. No result line."""
    import torch
    from dds_tpu_torch.obs.chronoscope import chronoscope

    phase_build(False)
    chronoscope.enabled = False  # CHRONOSCOPE_CUT; the later phases turn it on
    dev = torch.device("cuda")
    changed = {k: v for k, v in sizes.items() if CARD_SIZES.get(k) != v}
    for name in names:
        t = time.perf_counter()
        asyncio.run(globals()["phase_" + name](dev, sizes))
        emit("alone", name=name, seconds=time.perf_counter() - t, sizes=changed)
    print(nvidia_smi("name,power.limit"), flush=True)
    return 0


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
                  rsa_bits=1024, clients=4, ops_per_client=1024, B_probe=8192,  # DEPTH_CUTS
                  K_coalesce=128, coalesce_burst=16, coalesce_rounds=3,
                  coalesce_min_batch=None, K_multall=8192,  # DEPTH_CUTS
                  crossover_l64=[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384],
                  # mixed.py's preload of 4,096 rows cut to 1,024 and its 200
                  # ops a client to 25 (MIXED_CUT), for the run's time
                  mixed_replicas=7, mixed_quorum=5, mixed_preload=1024, mixed_clients=4,
                  mixed_ops=25, mixed_seed=7,
                  # the search phase: the write burst, warm reps a route, the
                  # cache-less baseline's reps, the plane alone at one full
                  # resident pool's rows
                  search_puts=64, search_writes=8, search_removes=8, search_reps=5,
                  search_baseline_reps=1, search_baseline_budget=300.0,
                  search_plane_rows=65536, search_plane_reps=20,
                  # configs/sharded.toml's [resident]; resident_fold.py's S and K
                  resident_groups=4, resident_initial=256, resident_max=65536,
                  resident_S=[1, 4], resident_K=[8192, 65536], resident_reps=1,
                  resident_new=256,
                  # analytics_matvec.py's R; the signed request's R; the slice
                  # held against the host loop
                  analytics_R=16, analytics_signed_R=4, analytics_slice=512,
                  # configs/stratum.toml's [resident] and [storage]; tiered_fold.py's
                  # pop-factor and theta
                  tier_groups=2, tier_max=4096, tier_chunk=256, tier_promote=2.0,
                  tier_max_promote=256, tier_pop_factor=10, tier_head=2048, tier_K=8192,
                  tier_theta=0.9, tier_reps=2, tier_warmup=3, tier_top=64,
                  # decrypt_throughput.py's sizes and B; the device plan at one
                  # and two full chunks; the rowmod parity's columns and digits;
                  # the plain ladder's columns
                  decrypt_bits=[1024, 2048], decrypt_B=256, decrypt_big=[4096, 8192],
                  decrypt_reps=3, rowmod_B=8192, rowmod_E=32, decrypt_plain_cols=64,
                  # the recovery phase: bft_sum's K rows on default.toml's
                  # topology, its timers as they stand, Trudy's seed
                  recovery_K=2048, recovery_scale=1.0, recovery_seed=5,
                  # the bulwark phase: bft_sum's K on default.toml as it
                  # stands; overload_goodput.py's rates, seed and a 10 s
                  # window, then a 5 s tail
                  bulwark_K=2048, bulwark_load_inflight=8, bulwark_flood_s=10.0,
                  bulwark_tail_s=5.0,
                  bulwark_interactive_rate=30.0, bulwark_aggregate_rate=400.0,
                  bulwark_seed=11,
                  # the tenancy phase: configs/tenancy.toml's key bits; 1,024
                  # rows a victim, 256 for the flooder (2,048 and 512 before
                  # the heliograph phase joined; DEPTH_CUTS); tenant_isolation.py's
                  # Zipf s, victim rate and aggregate share, a 10 s window,
                  # the flood from 2 s before it at 4 x the file's aggregate
                  # rate of 64/s
                  tenancy_paillier_bits=2048, tenancy_rsa_bits=1024, tenancy_rows=1024,
                  tenancy_flood_rows=256, tenancy_load_inflight=8, tenancy_seed=15,
                  tenancy_zipf_s=1.2, tenancy_interactive_rate=40.0, tenancy_agg_frac=0.1,
                  tenancy_window_s=10.0, tenancy_lead_s=2.0, tenancy_flood_rate=256.0,
                  # the heliograph phase: bft_sum's K (cut to 4,096, DEPTH_CUTS)
                  # on heliograph.toml as it stands, 64 PutSets in flight (the
                  # file arms no admission);
                  # canary_overhead.py's drill cadence (its --drill-cadence),
                  # at most 3 loopback cycles (the 4th re-puts the corrupted
                  # row); a 10 s open-loop window a side, GetSets at 30/s and
                  # SumAlls at 2/s
                  helio_K=4096, helio_inflight=64, helio_sumalls=6, helio_sumalls_compare=3,
                  helio_drill_cadence=0.25, helio_drill_cycles=3, helio_window_s=10.0,
                  helio_getset_rate=30.0, helio_sumall_rate=2.0, helio_seed=16,
                  helio_first_wait_s=60.0,
                  # the sharded phase: bft_sum's K (cut to 4,096, DEPTH_CUTS) on
                  # sharded.toml as it stands, 64 PutSets in flight, 6 SumAlls a
                  # route, 256 rows written once the pools exist,
                  # analytics_matvec.py's R = 16, 2 SumAlls in each Karatsuba
                  # mode; 2,048 rows on stratum.toml past a hot tier of 512
                  # rows a group (SHARDED_OVERRIDES), 3 SumAlls
                  sharded_K=4096, sharded_inflight=64, sharded_sumalls=6, sharded_new=256,
                  sharded_R=16, sharded_seed=17, sharded_mode_sumalls=2, stratum_K=2048,
                  stratum_max_rows=512, stratum_sumalls=3,
                  # the chaos phase: 1,024 rows (DEPTH_CUTS) on default.toml as it stands
                  # (CHAOS_OVERRIDES), 8 PutSets in flight within its PutSet
                  # objective; 8 PutSets and 3 SumAlls a fault step; the
                  # quorum-breaking partition's request budget; the read-back
                  # 64 in flight (nothing is measured after it)
                  chaos_K=1024, chaos_puts=8, chaos_sumalls=3, chaos_seed=19,
                  chaos_load_inflight=8, chaos_read_inflight=64, chaos_short_budget=2.0,
                  # the reshard phase: 2,048 rows on sharded.toml (RESHARD_OVERRIDES),
                  # 8 PutSets in flight within its PutSet objective; 320 candidate
                  # rows blinded with them, 32 of which the split moves (4 writers);
                  # 2 SumAlls a route and reshape; Helmsman's merge within 20 s of
                  # the unpin; the read-back 64 in flight
                  reshard_K=2048, reshard_inflight=8, reshard_candidates=320,
                  reshard_fresh=32, reshard_writers=4, reshard_sumalls=2,
                  reshard_pinned_ticks=3, reshard_merge_deadline_s=20.0,
                  reshard_read_inflight=64, reshard_seed=20,
                  # the mesh phase: the K = 8,192 fold (and 8,191) on D = 1-4 slots
                  # of the card, the B = 8,192 modexp, the backend's padded
                  # B = 8,190, the plane's 4 groups of 2,048 on D = 2, 4 and 3
                  # (group i on slot i mod D); 2,048 rows served by
                  # sharded.toml's 4 groups (cut from bft_sum's 8,192,
                  # DEPTH_CUTS), 3 SumAlls
                  mesh_K=8192, mesh_D=[1, 2, 3, 4], mesh_B=8192, mesh_B_backend=8190,
                  mesh_pow_check=64, mesh_plane_S=4, mesh_plane_rows=2048,
                  mesh_plane_D=[2, 4, 3], mesh_sumall_K=2048, mesh_sumalls=3, mesh_reps=3,
                  mesh_seed=21,
                  # the plain ladder of the exp timing on 1,024 of its 8,192
                  # columns, for the run's time (it took 83 s on all of them;
                  # 256 columns took as long as 1,024: the ladder's launches,
                  # not its columns, set its time)
                  exp_plain_cols=1024)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase tiny on the CPU (exits 3, no result)")
    ap.add_argument("--ab", metavar="PARENT",
                    help="time the B1/P/B3/B4/B5/REDC kernels and the folds of the tree at "
                         "PARENT and of this one in turns (parent, change, change, "
                         "parent); no result line")
    ap.add_argument("--phases", default="",
                    help="run these chip_smoke phases alone, after the build, at the card's "
                         "sizes (comma-separated, e.g. sharded or tenancy,heliograph; each "
                         "an async phase of (dev, sizes); no result line); with --ab: run "
                         "them of each tree instead")
    ap.add_argument("--size", action="append", default=[], metavar="KEY=VALUE",
                    help="with --phases alone: one of the card's sizes set to a JSON "
                         "value, e.g. sharded_K=8192 (repeatable)")
    ap.add_argument("--times", action="store_true",
                    help="print one JSON line of kernel times (used by --ab)")
    ap.add_argument("--tree", help="with --times: time the dds_tpu_torch of this tree")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    import torch

    if (args.ab or args.times or args.phases) and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.ab:
        return ab(args.ab, [p for p in args.phases.split(",") if p])
    if args.phases:
        sizes = {**CARD_SIZES, **{k: json.loads(v) for k, v in
                                  (kv.split("=", 1) for kv in args.size)}}
        return phases_alone([p for p in args.phases.split(",") if p], sizes)
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
                     decrypt_plain_cols=8, recovery_K=64, recovery_scale=0.1,
                     recovery_seed=5, bulwark_K=64, bulwark_load_inflight=8,
                     bulwark_flood_s=3.0, bulwark_tail_s=2.0,
                     bulwark_interactive_rate=10.0, bulwark_aggregate_rate=200.0,
                     bulwark_seed=11, tenancy_paillier_bits=512, tenancy_rsa_bits=512,
                     tenancy_rows=32, tenancy_flood_rows=16, tenancy_load_inflight=8,
                     tenancy_seed=15, tenancy_zipf_s=1.2, tenancy_interactive_rate=20.0,
                     tenancy_agg_frac=0.1, tenancy_window_s=2.0, tenancy_lead_s=1.0,
                     tenancy_flood_rate=64.0, helio_K=64, helio_inflight=16,
                     helio_sumalls=2, helio_sumalls_compare=2, helio_drill_cadence=0.05,
                     helio_drill_cycles=3, helio_window_s=2.0, helio_getset_rate=10.0,
                     helio_sumall_rate=2.0, helio_seed=16, helio_first_wait_s=60.0,
                     sharded_K=320, sharded_inflight=32, sharded_sumalls=2, sharded_new=16,
                     sharded_R=4, sharded_seed=17, sharded_mode_sumalls=1, stratum_K=288,
                     stratum_max_rows=64, stratum_sumalls=2, chaos_K=64, chaos_puts=4,
                     chaos_sumalls=2, chaos_seed=19, chaos_load_inflight=8,
                     chaos_read_inflight=16, chaos_short_budget=1.0, exp_plain_cols=16,
                     reshard_K=256, reshard_inflight=8, reshard_candidates=128,
                     reshard_fresh=8, reshard_writers=4, reshard_sumalls=1,
                     reshard_pinned_ticks=3, reshard_merge_deadline_s=20.0,
                     reshard_read_inflight=16, reshard_seed=20, mesh_K=256,
                     mesh_D=[1, 2, 3, 4], mesh_B=16, mesh_B_backend=14, mesh_pow_check=4,
                     mesh_plane_S=4, mesh_plane_rows=64, mesh_plane_D=[2, 4, 3],
                     mesh_sumall_K=64, mesh_sumalls=2, mesh_reps=1, mesh_seed=21)
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
    emit("cuts", earlier_phases=EARLIER_OBS_CUTS, recovery=RECOVERY_CUTS,
         timing_exp_plain_columns=sizes["exp_plain_cols"],
         bulwark_overrides=BULWARK_OVERRIDES, tenancy_overrides=TENANCY_OVERRIDES,
         heliograph_overrides=HELIOGRAPH_OVERRIDES, sharded_overrides=SHARDED_OVERRIDES,
         chaos_overrides=CHAOS_OVERRIDES, reshard_overrides=RESHARD_OVERRIDES,
         mesh_overrides=MESH_OVERRIDES,
         chronoscope_before_tenancy=CHRONOSCOPE_CUT, mixed=MIXED_CUT, depth=DEPTH_CUTS)

    from dds_tpu_torch.bench_key import bench_paillier_key
    from dds_tpu_torch.obs.chronoscope import chronoscope
    from dds_tpu_torch.ops.montgomery import ModCtx

    chronoscope.enabled = False  # CHRONOSCOPE_CUT; the tenancy phase turns it on

    ctx = ModCtx.make(bench_paillier_key(sizes["key_bits"]).nsquare)
    took: dict[str, float] = {}  # each phase's wall seconds, for the run's budget

    def timed(name: str, fn, *a):
        t = time.perf_counter()
        try:
            out = fn(*a)
        except BaseException as e:
            # name the phase that raised, on both streams, then fail as before
            line = json.dumps({"phase_failed": name, "error": repr(e),
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            print(line, file=sys.stderr, flush=True)
            raise
        took[name] = time.perf_counter() - t
        return out

    timed("build", phase_build, args.rehearse)
    par = timed("parity", phase_parity, ctx, dev, sizes)
    par_k = timed("parity_karatsuba", phase_parity_karatsuba, ctx, dev, sizes, par["k_rows"])
    par_nf = timed("parity_nofinal", phase_parity_nofinal, ctx, dev, sizes)
    par_exp = timed("parity_exp", phase_parity_exp, ctx, dev, sizes)
    par_rm = timed("parity_rowmod", phase_parity_rowmod, dev, sizes)
    tim = timed("timing", phase_timing, ctx, dev, sizes, card)
    tim_k = timed("timing_karatsuba", phase_timing_karatsuba, ctx, dev, sizes, card)
    tim_exp = timed("timing_exp", phase_timing_exp, ctx, dev, sizes, card)
    timed("crossover", phase_crossover, dev, ctx.n, sizes["crossover"])
    e2e = timed("e2e", asyncio.run, phase_e2e(dev, sizes))
    timed("coalesce", asyncio.run, phase_coalesce(dev, sizes))
    client = timed("client", asyncio.run, phase_client(dev, sizes))
    decrypt = timed("decrypt", phase_decrypt, dev, sizes, client, card)
    multall = timed("multall", asyncio.run, phase_multall(dev, sizes))
    mixed = timed("mixed", asyncio.run, phase_mixed(dev, sizes))
    plane = timed("search_plane", phase_search_plane, dev, sizes)
    resident = timed("resident", asyncio.run, phase_resident(dev, sizes))
    tiered = timed("tiered", asyncio.run, phase_tiered(dev, sizes))
    recovery = timed("recovery", asyncio.run, phase_recovery(dev, sizes))
    bulwark = timed("bulwark", asyncio.run, phase_bulwark(dev, sizes))
    tenancy = timed("tenancy", asyncio.run, phase_tenancy(dev, sizes))
    helio = timed("heliograph", asyncio.run, phase_heliograph(dev, sizes))
    sharded = timed("sharded", asyncio.run, phase_sharded(dev, sizes))
    chaos = timed("chaos", asyncio.run, phase_chaos(dev, sizes))
    reshard = timed("reshard", asyncio.run, phase_reshard(dev, sizes))
    mesh = timed("mesh", asyncio.run, phase_mesh(dev, sizes))
    emit("run", phase_seconds=took, seconds=time.perf_counter() - t_run)

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
                             "multall": multall["modes"]["0"]["launches"]["mont_mul"],
                             "mixed": mixed["mont_mul_launches"],
                             "resident": resident["modes"]["0"]["launches"]["mont_mul"],
                             "tiered": tiered["modes"]["0"]["launches"]["mont_mul"],
                             "recovery": recovery["launches"],
                             "sumall_audited": e2e["audited"]["launches"],
                             "bulwark": bulwark["launches"],
                             "tenancy": tenancy["launches"]["mont_mul"],
                             "heliograph": helio["launches"]["mont_mul"],
                             "sharded": sharded["launches"]["mont_mul"],
                             "stratum": sharded["stratum"]["launches"]["mont_mul"],
                             "chaos": chaos["launches"]["mont_mul"],
                             "reshard": reshard["launches"]["mont_mul"],
                             "mesh": mesh["launches"]["mont_mul"],
                             "mesh_sumall": mesh["sumall"]["launches"]},
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
        "launches_by_path": {"client": client["exp_launches"],
                             "tenancy": tenancy["launches"]["mont_exp"],
                             "heliograph": helio["launches"]["mont_exp"],
                             "sharded": sharded["launches"]["mont_exp"],
                             "chaos": chaos["launches"]["mont_exp"],
                             "reshard": reshard["launches"]["mont_exp"],
                             "mesh": mesh["launches"]["mont_exp"]},
        "max_abs_err": max(par_exp["max_abs_err"], tim_exp["max_abs_err"]),
        "per": f"one launch, B={tim_exp['B']}, E={tim_exp['E']} "
               f"({tim_exp['exp_products_per_row']} products per row); plain_ms on "
               f"{tim_exp['plain_columns']} columns",
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
    # the resident plane's folds, the tiered folds and sharded.toml's SumAlls
    # on the fused tree, in its mode
    k1, kf = ({k: {"sumall": e2e["karatsuba_modes"][m]["launches"][k],
                   "analytics": e2e["analytics"]["modes"][m]["launches"][k],
                   "multall": multall["modes"][m]["launches"][k],
                   "resident": resident["modes"][m]["launches"][k],
                   "tiered": tiered["modes"][m]["launches"][k],
                   "sharded": sharded["modes"][m]["launches"][k],
                   "mesh": mesh["modes"][m]["launches"][k]} for k in KARATSUBA_KERNELS}
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
    print(json.dumps({"recovery": {**recovery, "card": card["smi"] if "smi" in card
                                   else card["name"],
                                   "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"bulwark": {**bulwark, "card": card["smi"] if "smi" in card
                                  else card["name"],
                                  "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"tenancy": {**tenancy, "card": card["smi"] if "smi" in card
                                  else card["name"],
                                  "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"heliograph": {**helio, "card": card["smi"] if "smi" in card
                                     else card["name"],
                                     "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"sharded": {**sharded, "card": card["smi"] if "smi" in card
                                  else card["name"],
                                  "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"chaos": {**chaos, "card": card["smi"] if "smi" in card
                                else card["name"],
                                "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"reshard": {**reshard, "card": card["smi"] if "smi" in card
                                  else card["name"],
                                  "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
    print(json.dumps({"mesh": {**mesh, "card": card["smi"] if "smi" in card
                               else card["name"],
                               "run_seconds": time.perf_counter() - t_run}},
                     default=str), flush=True)
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
