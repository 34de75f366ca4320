"""Trudy and Nemesis: the process- and network-level fault injectors.

Copy of `dds_tpu/malicious/trudy.py` without the stale-tag forger (its
only caller is the multi-host group process): the attack enum and
parser; `Trudy`, which either crashes up to `max_faults` random replicas
(the endpoint is torn off the transport so it goes silent) or flips them
to the `byzantine` behaviour through the `Compromise` backdoor — replicas
honour both only when their deployment enables `[attacks]`; and
`Nemesis`, Trudy plus the network attacks `partition`, `delay`, `flood`
and `heal`, driven through the same `trigger()`. Partition, delay and
heal need the fabric to be a `ChaosNet` (`core/chaos.py`) and raise
TypeError on a plain transport; flood works on any transport (junk
Envelopes the replicas shed at their MAC check).

Victims are drawn from `_rng`, an explicit `random.Random`; seeded alike,
both packages pick the same victims.
"""

from __future__ import annotations

import enum
import logging
import random

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.chaos import ChaosNet, LinkFaults
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.trudy")


class AttackType(enum.Enum):
    CRASH = "crash"
    BYZANTINE = "byzantine"
    # network-level attacks (Nemesis; partition/delay/heal need a ChaosNet)
    PARTITION = "partition"
    DELAY = "delay"
    FLOOD = "flood"
    HEAL = "heal"


def parse_attack(name: str) -> AttackType:
    """The attack named `name`; raises on unknown attack names."""
    try:
        return AttackType(name.strip().lower())
    except ValueError:
        raise ValueError(
            f"unknown attack type {name!r} "
            "(crash|byzantine|partition|delay|flood|heal)"
        )


class Trudy:
    def __init__(self, net: Transport, replicas: list[str], max_faults: int = 2,
                 rng: random.Random | None = None, addr: str = "trudy"):
        self.net = net
        self.replicas = list(replicas)
        self.max_faults = max_faults
        self.addr = addr
        self._rng = rng or random.Random()

    def _victims(self) -> list[str]:
        return self._rng.sample(
            self.replicas, min(self.max_faults, len(self.replicas))
        )

    @staticmethod
    def _note_attack(attack: AttackType, victims: list[str]) -> None:
        """Trace event, counter and flight-recorder incident for every
        injected attack, so a failure records which fault fired and at
        whom."""
        names = [v.rsplit("/", 1)[-1] for v in victims]
        tracer.event("attack." + attack.value, victims=names)
        metrics.inc("dds_attacks_total", type=attack.value,
                    help="Trudy/Nemesis attacks triggered by type")
        flight.record("attack_" + attack.value, victims=names)

    def trigger(self, attack: AttackType | str) -> list[str]:
        """Attack up to max_faults random replicas; returns the victims.
        Both attacks travel as transport messages (`Crash` /
        `Compromise`)."""
        if isinstance(attack, str):
            attack = parse_attack(attack)
        victims = self._victims()
        for v in victims:
            if attack is AttackType.CRASH:
                log.info("Trudy crashes %s", v)
                self.net.send(self.addr, v, M.Crash())
            elif attack is AttackType.BYZANTINE:
                log.info("Trudy compromises %s", v)
                self.net.send(self.addr, v, M.Compromise())
            else:
                raise ValueError(
                    f"{attack.value!r} is a Nemesis attack — use Nemesis"
                )
        self._note_attack(attack, victims)
        return victims


class Nemesis(Trudy):
    """Trudy plus network-level attacks on a ChaosNet fabric.

    `partition` isolates the victims from the rest of the cluster
    (symmetric, with timed heal when `partition_duration` is set);
    `delay` injects fixed+jittered latency into every link toward the
    victims; `flood` bursts junk Envelopes at the victims (shed by their
    proxy-MAC validation — a load fault, not a correctness one); `heal`
    lifts every partition and link fault Nemesis (or anyone) installed."""

    def __init__(
        self,
        net: Transport,
        replicas: list[str],
        max_faults: int = 2,
        rng: random.Random | None = None,
        addr: str = "trudy",
        delay: float = 0.02,
        jitter: float = 0.02,
        flood_messages: int = 25,
        partition_duration: float | None = None,
    ):
        super().__init__(net, replicas, max_faults, rng, addr)
        self.delay = delay
        self.jitter = jitter
        self.flood_messages = flood_messages
        self.partition_duration = partition_duration
        self.active_partitions = []

    def _chaos(self) -> ChaosNet:
        if not isinstance(self.net, ChaosNet):
            raise TypeError(
                "partition/delay/heal attacks need a ChaosNet fabric; "
                f"got {type(self.net).__name__}"
            )
        return self.net

    def trigger(self, attack: AttackType | str) -> list[str]:
        if isinstance(attack, str):
            attack = parse_attack(attack)
        if attack in (AttackType.CRASH, AttackType.BYZANTINE):
            return super().trigger(attack)
        if attack is AttackType.HEAL:
            log.info("Nemesis heals the network")
            self._chaos().heal_all()
            self.active_partitions.clear()
            self._note_attack(attack, [])
            return []
        victims = self._victims()
        if attack is AttackType.PARTITION:
            log.info("Nemesis partitions %s", victims)
            self.active_partitions.append(
                self._chaos().partition(
                    victims, duration=self.partition_duration
                )
            )
        elif attack is AttackType.DELAY:
            log.info("Nemesis delays links to %s", victims)
            chaos = self._chaos()
            for v in victims:
                chaos.set_dest(
                    v.rsplit("/", 1)[-1],
                    LinkFaults(delay=self.delay, jitter=self.jitter),
                )
        elif attack is AttackType.FLOOD:
            log.info("Nemesis floods %s", victims)
            for v in victims:
                for _ in range(self.flood_messages):
                    # junk under a garbage signature: replicas burn a MAC
                    # check and drop it — pure load, no protocol effect
                    self.net.send(
                        self.addr, v,
                        M.Envelope(
                            M.IRead(f"flood-{self._rng.getrandbits(32):08x}"),
                            self._rng.getrandbits(63),
                            b"nemesis-junk",
                        ),
                    )
        self._note_attack(attack, victims)
        return victims
