"""Live resharding: epoch-fenced, Byzantine-verified key migration.

Copy of `dds_tpu/shard/rebalance.py`: the same plan journal, phases,
manifests, migration frames, aborts and recovery, so one reshape gives
the same map, repositories and acks in both packages. The group handles
here are the in-process `shard.fabric.ShardGroup`s, which answer
synchronously; `_maybe_await` keeps the reference's duck-typed surface
for awaitable handles, and `on_activate` its hook for a broadcast.

Reshaping a shard group — splitting a hot one onto a standby, or merging
a cold one back into its ring neighbors — is a five-step protocol built
from pieces the stack already trusts: epoch fencing (shard/shardmap +
core/replica) and Aegis verified state transfer (StateDigest manifests,
chunked streaming, >= f+1 distinct-signer attestation):

1. **plan**   — derive the epoch+1 map (`ShardMap.split` / `.merge`) and
   sign it. The plan is journaled (`PlanJournal`) before any state moves
   so a crashed controller is resolved deterministically on restart.
2. **freeze** — install the new map on every PARTICIPANT group's fencing
   state, under a fence LEASE (TTL): from this instant every write to a
   moving key is fenced (coordinator Envelope check + storage-layer
   Write check), so the moving slice of the keyspace is immutable while
   it is copied; clients retry under their Deadline budgets and land on
   the new owner after activation. The router still serves the OLD map —
   unmoved keys see zero disruption. If the controller dies here, the lease
   expires and every participant heals back to the committed map on its
   own — no group is ever fenced forever.
3. **attest** — collect a quorum of HMAC-signed state manifests from the
   source group (the same frames recovery uses). Fewer than `support`
   (= f+1) attestations aborts: an unverifiable migration never ships.
4. **stream** — export the moving keys from the best-attested source
   replica (data, not truth) and stream ShardMigrateBegin + bounded
   StateChunk(kind="migrate") frames to EVERY receiving replica, which
   installs only entries attested by >= f+1 distinct signers and owned
   under ITS map, store-if-newer. A quorum of acks each accepting the
   full verified slice is required per receiving group — a Byzantine
   source replica that withholds or corrupts entries fails the ack bar
   and aborts. (A split streams to one target; a merge partitions the
   victim's keys by their NEW ring owner and streams one session per
   absorbing group.)
5. **commit + activate** — every participant re-installs the new map
   WITHOUT a lease (the fencing point of no return, acked; failure still
   aborts safely), then the router's ShardManager adopts the new map,
   the source group prunes its moved keys, and the receivers' own Merkle
   anti-entropy loops repair any replica that missed chunks.

Any failure before commit rolls the fencing state back to the old map
(force install — and any participant the rollback cannot reach heals
itself when its fence lease expires), records a `reshard_abort` flight
incident + metric, and raises `ReshardAborted` — the keyspace is exactly
as before, minus the brief write stall on the moving slice.

Crash safety: the journal names the plan's phase. `recover()` resolves
an interrupted plan deterministically — phases before "commit" roll
BACK (the router never activated; the old map is the truth), "commit"
and later roll FORWARD (participants hold committed new-map fencing;
re-activate, re-broadcast, re-prune).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
import os
import pathlib
import time

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.replica import verified_manifest
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.shard.shardmap import ShardMap
from dds_tpu_torch.utils import sigs
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.shard.rebalance")

# phase -> worst-case seconds the plan can still spend there, for the
# 409 Retry-After a concurrent /_reshard answer derives (manifest and
# ack timeouts are added by retry_after(); this covers the fixed tail)
_PHASES = ("plan", "freeze", "attest", "stream", "commit", "activate")


class ReshardAborted(RuntimeError):
    """A live reshard failed safely: the old map is back in force."""


async def _maybe_await(value):
    """Group handles are duck-typed: the in-process `ShardGroup` answers
    state installs / exports / prunes synchronously, the Meridian
    `RemoteShardGroup` returns awaitables that resolve on the remote
    agent's ack. The rebalancer awaits whichever it gets."""
    if inspect.isawaitable(value):
        return await value
    return value


def _entries_bytes(entries: dict) -> int:
    """Approximate migrated payload size — the BTS-style cost every plan
    is priced in (migrated ciphertext bytes, not group count)."""
    try:
        return len(json.dumps(entries, default=repr, separators=(",", ":")))
    except (TypeError, ValueError):
        return sum(len(k) + len(repr(v)) for k, v in entries.items())


class PlanJournal:
    """Crash-safe reshard plan state: one JSON file, written atomically
    (tmp + rename) at every phase transition and cleared when the plan
    resolves. A controller that restarts reads the file and knows exactly
    how far the interrupted plan got — the basis of `Rebalancer.recover`.
    Directory empty/None = in-memory only (tests, ephemeral fleets)."""

    def __init__(self, directory: str | None = None,
                 name: str = "reshard_plan.json"):
        self._dir = pathlib.Path(directory) if directory else None
        self._name = name
        self._mem: dict | None = None

    @property
    def path(self) -> pathlib.Path | None:
        return self._dir / self._name if self._dir else None

    def write(self, plan: dict) -> None:
        self._mem = dict(plan)
        if self._dir is None:
            return
        self._dir.mkdir(parents=True, exist_ok=True)
        tmp = self._dir / (self._name + ".tmp")
        tmp.write_text(json.dumps(plan, separators=(",", ":")))
        os.replace(tmp, self._dir / self._name)

    def load(self) -> dict | None:
        if self._dir is not None:
            p = self._dir / self._name
            try:
                return json.loads(p.read_text())
            except FileNotFoundError:
                return None
            except (ValueError, OSError) as e:
                log.warning("unreadable reshard journal %s: %s", p, e)
                return None
        return dict(self._mem) if self._mem else None

    def clear(self) -> None:
        self._mem = None
        if self._dir is not None:
            try:
                (self._dir / self._name).unlink()
            except FileNotFoundError:
                pass


class Rebalancer:
    def __init__(self, manager, net, abd_mac_secret: bytes,
                 addr: str = "rebalancer", manifest_timeout: float = 2.0,
                 ack_timeout: float = 5.0, chunk_keys: int = 256,
                 prune: bool = True, on_activate=None,
                 fence_lease: float = 0.0, journal_dir: str | None = None,
                 clock=time.monotonic):
        self.manager = manager
        self.net = net
        self.secret = abd_mac_secret
        self.addr = addr
        self.manifest_timeout = manifest_timeout
        self.ack_timeout = ack_timeout
        self.chunk_keys = chunk_keys
        # Meridian hook: fires (sync or async) with the activated map
        # right after cut-over, BEFORE the prune — the multi-host
        # controller broadcasts ShardMapActivate to every group agent
        # here so remote /shards views and long-pollers see the bump
        self.on_activate = on_activate
        # pruning the source group's moved keys after activation is the
        # production default; tests keep the pre-split state around to
        # assert zero stale-epoch writes ever landed there
        self.prune = prune
        # fence-lease TTL handed to every freeze install (0 = legacy
        # no-lease installs, kept for old handles/spies); sized so a live
        # plan always commits or aborts well inside one TTL
        self.fence_lease = fence_lease
        self.journal = PlanJournal(journal_dir)
        self._clock = clock
        # one plan at a time: the controller-owned serialization point
        # every reshard entrypoint (Helmsman, POST /_reshard, tests)
        # funnels through
        self.lock = asyncio.Lock()
        self.phase: str | None = None
        self._phase_at = 0.0
        self.plan_info: dict | None = None
        self.last_moved_keys = 0
        self.last_moved_bytes = 0
        self.moved_bytes_total = 0
        # nonce -> (future, sender -> StateDigest, target count)
        self._manifest_collects: dict[int, tuple] = {}
        # session -> (future, sender -> ShardMigrateAck, needed)
        self._ack_collects: dict[int, tuple] = {}
        net.register(addr, self._handle)

    async def _handle(self, sender: str, msg) -> None:
        if isinstance(msg, M.StateDigest):
            coll = self._manifest_collects.get(msg.nonce)
            if coll is None:
                return
            fut, votes, target = coll
            if sender in votes:
                return
            if not sigs.validate_manifest_signature(
                self.secret, sender, msg.manifest, msg.nonce, msg.signature
            ):
                log.warning("dropping StateDigest with bad HMAC from %s",
                            sender)
                return
            votes[sender] = msg
            if len(votes) >= target and not fut.done():
                fut.set_result(None)
        elif isinstance(msg, M.ShardMigrateAck):
            coll = self._ack_collects.get(msg.session)
            if coll is None:
                return
            fut, acks, needed = coll
            acks[sender] = msg
            if len(acks) >= needed and not fut.done():
                fut.set_result(None)

    # -------------------------------------------------------------- phases

    def _enter(self, phase: str, **info) -> None:
        self.phase = phase
        self._phase_at = self._clock()
        if self.plan_info is not None:
            self.plan_info["phase"] = phase
            self.journal.write(self.plan_info)
        if info:
            tracer.event("shard.phase", phase=phase, **info)

    def _resolve(self) -> None:
        self.phase = None
        self.plan_info = None
        self.journal.clear()

    def retry_after(self) -> float:
        """Honest Retry-After for a caller refused because a plan is in
        flight: the worst-case seconds the CURRENT phase (and the fixed
        tail after it) can still take before the lock frees."""
        if self.phase is None:
            return 1.0
        elapsed = max(0.0, self._clock() - self._phase_at)
        budget = {
            "plan": self.manifest_timeout + self.ack_timeout + 2.0,
            "freeze": self.manifest_timeout + self.ack_timeout + 2.0,
            "attest": self.manifest_timeout + self.ack_timeout + 1.0,
            "stream": self.ack_timeout + 1.0,
            "commit": 2.0,
            "activate": 1.0,
        }.get(self.phase, self.ack_timeout)
        return max(0.5, round(budget - elapsed, 2))

    # ------------------------------------------------------------- manifest

    async def _collect_manifests(self, replicas: list[str],
                                 quorum: int) -> dict:
        nonce = sigs.generate_nonce()
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        votes: dict[str, M.StateDigest] = {}
        self._manifest_collects[nonce] = (fut, votes,
                                          min(len(replicas), quorum))
        for r in replicas:
            self.net.send(self.addr, r, M.StateDigestRequest(nonce))
        try:
            await asyncio.wait_for(fut, self.manifest_timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._manifest_collects.pop(nonce, None)
        return votes

    # ---------------------------------------------------------- install ops

    async def _install(self, grp, smap: ShardMap, *, force: bool = False,
                       lease: float = 0.0):
        """Fencing install on one participant. The lease kwarg is only
        passed when armed, so legacy handles (and test spies) with the
        old two-argument surface keep working."""
        if lease > 0:
            return await _maybe_await(
                grp.state.install(smap, force=force, lease=lease)
            )
        return await _maybe_await(grp.state.install(smap, force=force))

    async def _freeze(self, participants, new_map: ShardMap) -> None:
        # every participant fences under the NEW map from here on (remote
        # groups ack the install before anything streams — streaming into
        # an unfenced group would break the immutable-while-copied
        # guarantee). Provisional: the fence lease heals a participant
        # whose controller dies before commit/abort.
        for grp in participants:
            await self._install(grp, new_map, lease=self.fence_lease)

    async def _renew(self, participants, new_map: ShardMap) -> None:
        """Best-effort lease renewal before the stream phase — a slow
        attest must not leave the stream racing the freeze TTL."""
        if self.fence_lease <= 0:
            return
        for grp in participants:
            try:
                await self._install(grp, new_map, lease=self.fence_lease)
            except Exception as e:
                log.warning("lease renewal on %s failed: %s", grp.gid, e)

    async def _commit(self, participants, new_map: ShardMap) -> None:
        # the fencing point of no return: re-install WITHOUT a lease so
        # the new map is the committed state every participant heals TO,
        # not from. Acked — a participant that cannot commit aborts the
        # plan while rollback is still the safe resolution.
        for grp in participants:
            await self._install(grp, new_map)

    # ---------------------------------------------------------------- split

    async def split(self, source, target) -> "object":
        """Split `source`'s keyspace, moving ~half to `target` (both are
        shard.fabric.ShardGroup handles). Returns the activated ShardMap;
        raises ReshardAborted with the old map restored on any failure."""
        async with self.lock:
            old_map = self.manager.current()
            new_map = old_map.split(source.gid, target.gid).sign(self.secret)
            return await self._run_plan("split", source, [target],
                                        old_map, new_map)

    async def merge(self, victim, receivers) -> "object":
        """Merge `victim` away: its vnodes retire and every key it owned
        streams to its ring successor group(s) (`receivers`, the handles
        for `old_map.absorbers(victim.gid)` in that order). Same freeze/
        attest/stream/commit/activate machinery and >= f+1 attestation
        discipline as `split`; the victim ends the plan owning nothing
        (and pruned, when pruning is on) — a warm standby again."""
        async with self.lock:
            old_map = self.manager.current()
            new_map = old_map.merge(victim.gid).sign(self.secret)
            want = old_map.absorbers(victim.gid)
            got = [r.gid for r in receivers]
            if sorted(got) != sorted(want):
                raise ValueError(
                    f"merge receivers {got} != ring absorbers {want}"
                )
            return await self._run_plan("merge", victim, receivers,
                                        old_map, new_map)

    async def _run_plan(self, kind: str, source, targets,
                        old_map: ShardMap, new_map: ShardMap):
        support = max(1, 2 * source.quorum_size - len(source.active))
        self.plan_info = {
            "kind": kind, "source": source.gid,
            "targets": [t.gid for t in targets],
            "old": old_map.to_wire(), "new": new_map.to_wire(),
            "phase": "plan",
        }
        self._enter("plan", kind=kind, source=source.gid)
        self.manager.begin_reshard()
        metrics.set("dds_shard_reshard_state", 1,
                    help="0=stable 1=resharding")
        participants = [source] + list(targets)
        with tracer.span(f"shard.{kind}", source=source.gid,
                         targets=",".join(t.gid for t in targets),
                         epoch=new_map.epoch) as span:
            try:
                self._enter("freeze")
                await self._freeze(participants, new_map)
                moved = await self._migrate(kind, source, targets,
                                            old_map, new_map, support)
                span["moved"] = moved
            except ReshardAborted:
                raise
            except Exception as e:  # any unplanned failure aborts safely
                await self._abort(kind, source, targets, old_map,
                                  f"unexpected: {e!r}")
            finally:
                self.manager.end_reshard()
                metrics.set("dds_shard_reshard_state", 0,
                            help="0=stable 1=resharding")
                self._resolve()
        return self.manager.current()

    async def _migrate(self, kind: str, source, targets, old_map,
                       new_map, support: int) -> int:
        self._enter("attest")
        votes = await self._collect_manifests(source.active,
                                              source.quorum_size)
        if len(votes) < support:
            await self._abort(
                kind, source, targets, old_map,
                f"manifest quorum failed: {len(votes)}/{len(source.active)} "
                f"attested (need >= {support})",
            )
        digests = [
            [sender, d.manifest, d.nonce, d.signature.hex()]
            for sender, d in votes.items()
        ]
        verified = verified_manifest(digests, support, self.secret)
        # moving = verified keys whose owner changes source -> target(s):
        # for a split, the slice the new group takes; for a merge, every
        # key the victim owned, partitioned by its NEW ring owner
        receiver_gids = {t.gid for t in targets}
        moving = {
            k: v for k, v in verified.items()
            if old_map.owner(k) == source.gid
            and new_map.owner(k) in receiver_gids
        }

        # seed source: the attesting replica whose manifest covers the most
        # verified moving entries — its export is still just DATA (receivers
        # re-verify every entry against the digest quorum)
        def coverage(sender: str) -> int:
            m = votes[sender].manifest
            return sum(
                1 for k, want in moving.items()
                if k in m and (int(m[k][0]), str(m[k][1]), str(m[k][2]))
                == want
            )

        seeder = max(votes, key=coverage) if votes else None
        exported = (
            await _maybe_await(source.export_from(seeder)) if seeder else {}
        )
        entries = {k: e for k, e in exported.items() if k in moving}

        await self._renew([source] + list(targets), new_map)
        self._enter("stream")
        moved_bytes = 0
        sessions = []
        for target in targets:
            slice_keys = {
                k for k in moving if new_map.owner(k) == target.gid
            }
            slice_entries = {k: e for k, e in entries.items()
                             if k in slice_keys}
            moved_bytes += _entries_bytes(slice_entries)
            sessions.append((target, len(slice_keys), slice_entries))

        async def stream_one(target, want: int, slice_entries: dict) -> bool:
            session = sigs.generate_nonce()
            items = sorted(slice_entries.items())
            k = max(1, self.chunk_keys)
            chunks = ([dict(items[i:i + k])
                       for i in range(0, len(items), k)] or [{}])
            replicas = target.all_replicas()
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            acks: dict[str, M.ShardMigrateAck] = {}
            self._ack_collects[session] = (fut, acks, target.quorum_size)
            begin = M.ShardMigrateBegin(digests, session, len(chunks),
                                        support, new_map.epoch)
            for t in replicas:
                self.net.send(self.addr, t, begin)
                for seq, chunk in enumerate(chunks):
                    self.net.send(
                        self.addr, t,
                        M.StateChunk(session, seq, chunk, kind="migrate"),
                    )
            tracer.event("shard.migrate", source=source.gid,
                         target=target.gid, keys=len(slice_entries),
                         chunks=len(chunks), seeder=seeder)
            try:
                await asyncio.wait_for(fut, self.ack_timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                self._ack_collects.pop(session, None)
            good = [a for a in acks.values() if a.accepted >= want]
            return len(good) >= target.quorum_size

        results = await asyncio.gather(
            *(stream_one(t, w, s) for t, w, s in sessions)
        )
        failed = [t.gid for (t, _, _), ok in zip(sessions, results)
                  if not ok]
        if failed:
            await self._abort(
                kind, source, targets, old_map,
                f"migration ack quorum failed for group(s) "
                f"{', '.join(failed)} (need >= quorum replicas accepting "
                f"every verified key of their slice)",
            )

        # fencing point of no return: every participant commits the new
        # map (no lease) BEFORE the router cut-over, so an unreachable
        # participant aborts here — after this line the plan only ever
        # rolls forward
        self._enter("commit")
        try:
            await self._commit([source] + list(targets), new_map)
        except Exception as e:
            await self._abort(kind, source, targets, old_map,
                              f"fence commit failed: {e!r}")

        # cut-over: routers resolve the new map from the next attempt on
        self._enter("activate")
        self.manager.activate(new_map)
        metrics.set("dds_shard_epoch", new_map.epoch,
                    help="active shard-map epoch")
        want = len(moving)
        self.last_moved_keys = want
        self.last_moved_bytes = moved_bytes
        self.moved_bytes_total += moved_bytes
        metrics.inc("dds_reshard_moved_bytes_total", moved_bytes,
                    help="approximate ciphertext bytes migrated by live "
                         "resharding (the BTS cost model's currency)")
        if self.on_activate is not None:
            await _maybe_await(self.on_activate(new_map))
        if self.prune:
            dropped = await _maybe_await(source.prune_unowned())
            tracer.event("shard.pruned", source=source.gid, dropped=dropped)
        log.info(
            "%s complete: %s -> %s, epoch %d, %d keys (%d bytes) moved",
            kind, source.gid, ",".join(t.gid for t in targets),
            new_map.epoch, want, moved_bytes,
        )
        return want

    async def _abort(self, kind: str, source, targets, old_map,
                     reason: str) -> None:
        # roll fencing back to the old map (force: epoch goes backwards;
        # no lease: the old map is the committed state again); the router
        # never saw the new map, so routing is untouched. A REMOTE
        # rollback can itself fail (agent unreachable) — the group then
        # stays fenced under the orphaned epoch, which is safe (fencing
        # rejects, never misroutes) and heals ITSELF when its fence
        # lease expires (or at the next install, whichever is sooner);
        # it must not mask the abort itself.
        for grp in [source] + list(targets):
            try:
                await self._install(grp, old_map, force=True)
            except Exception:
                log.exception(
                    "reshard abort could not roll %s back to epoch %d "
                    "(group heals when its fence lease expires)",
                    grp.gid, old_map.epoch,
                )
        metrics.inc("dds_reshard_aborts_total",
                    help="live resharding attempts aborted safely")
        tracer.event("shard.reshard_abort", kind=kind, source=source.gid,
                     targets=",".join(t.gid for t in targets),
                     reason=reason)
        await flight.record_async("reshard_abort", plan=kind,
                                  source=source.gid,
                                  target=",".join(t.gid for t in targets),
                                  reason=reason, epoch=old_map.epoch)
        log.warning("%s %s -> %s aborted: %s", kind, source.gid,
                    ",".join(t.gid for t in targets), reason)
        raise ReshardAborted(reason)

    # ------------------------------------------------------------- recovery

    async def recover(self, handle_for) -> str | None:
        """Resolve a plan an earlier (crashed) controller left in the journal.
        `handle_for(gid)` returns a group handle. Deterministic rule:

        - phase before "commit": roll BACK — the router never activated,
          so the old map is the truth; force-install it on every
          participant (best effort: a participant the rollback cannot
          reach heals itself when its fence lease expires).
        - phase "commit"/"activate": roll FORWARD — participants hold
          (or were told to hold) committed new-map fencing; finish the
          cut-over: commit installs, activate the manager, broadcast,
          prune the source.

        Returns "rollback", "rollforward", or None (no interrupted plan).
        """
        plan = self.journal.load()
        if not plan:
            return None
        kind = plan.get("kind", "split")
        phase = plan.get("phase", "plan")
        old_map = ShardMap.from_wire(plan["old"])
        new_map = ShardMap.from_wire(plan["new"])
        gids = [plan["source"]] + list(plan.get("targets", []))
        handles = []
        for gid in gids:
            try:
                handles.append(handle_for(gid))
            except Exception as e:
                log.warning("recovery has no handle for %s: %s", gid, e)
        forward = phase in ("commit", "activate")
        action = "rollforward" if forward else "rollback"
        target_map = new_map if forward else old_map
        for grp in handles:
            try:
                await self._install(grp, target_map, force=not forward)
            except Exception as e:
                log.warning(
                    "recovery %s install on %s failed (%s); its fence "
                    "lease heals it", action, grp.gid, e,
                )
        if forward:
            if new_map.epoch > self.manager.epoch:
                self.manager.activate(new_map)
                metrics.set("dds_shard_epoch", new_map.epoch,
                            help="active shard-map epoch")
            if self.on_activate is not None:
                try:
                    await _maybe_await(self.on_activate(new_map))
                except Exception as e:
                    log.warning("recovery activation broadcast failed: %s", e)
            if self.prune and handles:
                try:
                    await _maybe_await(handles[0].prune_unowned())
                except Exception as e:
                    log.warning("recovery prune of %s failed: %s",
                                gids[0], e)
        self.journal.clear()
        metrics.inc("dds_reshard_recoveries_total", action=action,
                    help="interrupted reshard plans resolved at restart")
        await flight.record_async("reshard_recovered", plan=kind,
                                  phase=phase, action=action,
                                  source=plan["source"],
                                  targets=",".join(plan.get("targets", [])),
                                  old_epoch=old_map.epoch,
                                  new_epoch=new_map.epoch)
        log.warning("recovered interrupted %s (%s phase) by %s",
                    kind, phase, action)
        return action
