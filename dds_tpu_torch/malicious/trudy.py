"""Trudy: the process-level fault injector.

Trimmed copy of `dds_tpu/malicious/trudy.py`: the attack enum and parser,
and `Trudy`, which either crashes up to `max_faults` random replicas (the
endpoint is torn off the transport so it goes silent) or flips them to
the `byzantine` behaviour through the `Compromise` backdoor. Replicas
honour both only when their deployment enables `[attacks]`. Nemesis's
network attacks (partition, delay, flood, heal) need ChaosNet, which is
not ported: the enum names them so a config parses the same, and
`trigger` refuses them.

Victims are drawn from `_rng`, an explicit `random.Random`; seeded alike,
both packages pick the same victims.
"""

from __future__ import annotations

import enum
import logging
import random

from dds_tpu_torch.core import messages as M
from dds_tpu_torch.core.transport import Transport
from dds_tpu_torch.obs.flight import flight
from dds_tpu_torch.obs.metrics import metrics
from dds_tpu_torch.utils.trace import tracer

log = logging.getLogger("dds_torch.trudy")


class AttackType(enum.Enum):
    CRASH = "crash"
    BYZANTINE = "byzantine"
    # network-level attacks (Nemesis; they need ChaosNet, not ported)
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
        if attack not in (AttackType.CRASH, AttackType.BYZANTINE):
            raise ValueError(
                f"{attack.value!r} is a Nemesis attack, which needs ChaosNet "
                "(not ported)"
            )
        victims = self._victims()
        for v in victims:
            if attack is AttackType.CRASH:
                log.info("Trudy crashes %s", v)
                self.net.send(self.addr, v, M.Crash())
            else:
                log.info("Trudy compromises %s", v)
                self.net.send(self.addr, v, M.Compromise())
        self._note_attack(attack, victims)
        return victims
