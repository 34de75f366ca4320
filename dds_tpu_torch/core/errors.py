"""Typed Byzantine-failure exceptions (copy of `dds_tpu/core/errors.py`,
trimmed to the protocol-violation family the quorum client raises)."""


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
