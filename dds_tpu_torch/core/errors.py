"""Typed Byzantine-failure exceptions (copy of `dds_tpu/core/errors.py`,
trimmed to the protocol-violation family the quorum client raises, the
all-breakers-open fast-fail and the shard fence)."""


class ByzantineError(Exception):
    """Base class for protocol-violation failures detected at the proxy."""


class ByzFailedNonceChallengeError(ByzantineError):
    """Reply nonce did not match the expected challenge (nonce + increment)."""


class ByzInvalidSignatureError(ByzantineError):
    """HMAC verification failed on a reply."""


class ByzInvalidKeyError(ByzantineError):
    """Reply echoed a different record key than requested."""


class ByzUnknownReplyError(ByzantineError):
    """Reply type made no sense for the outstanding request."""


class AllBreakersOpenError(Exception):
    """Every trusted coordinator's circuit breaker is open AND none will
    half-open within the caller's remaining budget — the attempt is
    provably futile, so the storage layer degrades immediately instead of
    burning the Deadline on timeouts against targets it already knows are
    refusing traffic (Bulwark fast-fail, core/admission). NOT a
    ByzantineError: nobody misbehaved, the fabric is just down. `eta` is
    the nearest half-open probe in seconds — the REST edge derives
    Retry-After from it."""

    def __init__(self, eta: float, targets: int = 0):
        self.eta = eta
        self.targets = targets
        super().__init__(
            f"all {targets} trusted coordinators have open breakers "
            f"(nearest half-open probe in {eta:.3f}s)"
        )


class WrongShardError(Exception):
    """The addressed replica group does not own the key under its current
    shard map (Constellation epoch fencing, `shard/`). NOT a
    ByzantineError: the replica behaved correctly — the caller's shard map
    is stale (or a reshard is mid-flight). The proxy refreshes its map and
    retries under the existing Deadline budget; no suspicion accrues."""

    def __init__(self, key: str, replica_epoch: int | None = None,
                 sent_epoch: int | None = None):
        self.key = key
        self.replica_epoch = replica_epoch
        self.sent_epoch = sent_epoch
        super().__init__(
            f"key {key[:16]}... not owned by addressed group "
            f"(replica epoch {replica_epoch}, request epoch {sent_epoch})"
        )
