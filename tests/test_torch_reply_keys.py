"""A quorum reply for another key, against `dds_tpu.core.replica` (ROADMAP §C 17).

The intranet ABD signature covers (value, tag, nonce), not the key, and
ChaosNet's one-byte corruption can flip the case of one letter of a hex
record key and still decode. The reference's coordinator takes the key
of the TagReply (or ReadReply) that completes its quorum for the Write
it then broadcasts, so one such reply sends the whole write to another
key while the proxy is told that its key was written: the acknowledged
row is then missing from every aggregate. The port's coordinator drops a
reply for another key before it joins the quorum, so the Write goes to
the key the proxy signed. The same messages go to one coordinator
of each package; the reference's fault is kept in its twin.
"""

import asyncio
import importlib

import pytest

PACKAGES = ("dds_tpu", "dds_tpu_torch")
ADDRS = [f"replica-{i}" for i in range(7)]
QUORUM = 5
VALUE = ["7"]
NONCE = 4242


def mods(pkg: str):
    class _M:
        pass

    m = _M()
    m.M = importlib.import_module(f"{pkg}.core.messages")
    m.rep = importlib.import_module(f"{pkg}.core.replica")
    m.sigs = importlib.import_module(f"{pkg}.utils.sigs")
    return m


class Sink:
    """A transport that only records what the coordinator sends."""

    def __init__(self):
        self.sent = []

    def send(self, src, dest, msg):
        self.sent.append((dest, msg))

    def register(self, *_a):
        pass


def flipped(key: str) -> str:
    """`key` with its first letter's case flipped: one byte ^ 0x20, as a
    corrupting link can deliver it."""
    i = next(i for i, ch in enumerate(key) if ch.isalpha())
    return key[:i] + key[i].swapcase() + key[i + 1:]


def coordinator(pkg: str):
    m = mods(pkg)
    net = Sink()
    cfg = m.rep.ReplicaConfig(quorum_size=QUORUM)
    return m, net, cfg, m.rep.BFTABDNode(ADDRS[0], ADDRS, "supervisor", net, cfg)


def writes(m, net) -> list:
    return [msg for _, msg in net.sent if isinstance(msg, m.M.Write)]


def broadcast(k: str) -> list:
    """The keys of one Write broadcast to every replica."""
    return [k] * len(ADDRS)


async def drive_write(pkg: str, key: str) -> tuple:
    """The proxy's IWrite of `key`, then TagReplies of every replica but
    the coordinator, the quorum's last one for the case-flipped key, then
    one more for `key`: the keys of the Writes broadcast after the quorum's
    replies and after the extra one."""
    m, net, cfg, node = coordinator(pkg)
    sig = m.sigs.proxy_signature(cfg.proxy_mac_secret, key, NONCE, VALUE)
    await node.handle("proxy", m.M.Envelope(m.M.IWrite(key, VALUE), NONCE, sig))
    keys = [key] * (QUORUM - 1) + [flipped(key), key]
    seen = []
    for sender, k in zip(ADDRS[1:], keys):
        tag = m.M.ABDTag(3, sender)
        tsig = m.sigs.abd_signature(cfg.abd_mac_secret, None, tag, NONCE)
        await node.handle(sender, m.M.TagReply(tag, k, None, tsig, NONCE))
        seen.append([w.key for w in writes(m, net)])
    return seen[QUORUM - 1], seen[QUORUM]


async def drive_read(pkg: str, key: str) -> tuple:
    """The proxy's IRead of `key`, then ReadReplies at two tags (so the
    write-back phase runs), the quorum's last one for the case-flipped
    key, then one more for `key`: the keys of the write-back Writes."""
    m, net, cfg, node = coordinator(pkg)
    sig = m.sigs.proxy_signature(cfg.proxy_mac_secret, key, NONCE)
    await node.handle("proxy", m.M.Envelope(m.M.IRead(key), NONCE, sig))
    keys = [key] * (QUORUM - 1) + [flipped(key), key]
    seen = []
    for i, (sender, k) in enumerate(zip(ADDRS[1:], keys)):
        tag = m.M.ABDTag(5 if i == 0 else 4, sender)
        tsig = m.sigs.abd_signature(cfg.abd_mac_secret, VALUE, tag, NONCE)
        await node.handle(sender, m.M.ReadReply(tag, k, VALUE, tsig, NONCE))
        seen.append([w.key for w in writes(m, net)])
    return seen[QUORUM - 1], seen[QUORUM]


@pytest.fixture
def key():
    return mods("dds_tpu_torch").sigs.key_from_set(VALUE)  # upper-case hex


def test_a_tag_reply_for_another_key_redirects_the_references_write_not_the_ports(key):
    ref_at_quorum, _ = asyncio.run(drive_write("dds_tpu", key))
    assert ref_at_quorum == broadcast(flipped(key))  # the reference writes the flipped key
    port_at_quorum, port_after = asyncio.run(drive_write("dds_tpu_torch", key))
    assert port_at_quorum == []  # the flipped reply did not complete the quorum
    assert port_after == broadcast(key)


def test_a_read_reply_for_another_key_redirects_the_references_write_back_not_the_ports(key):
    ref_at_quorum, _ = asyncio.run(drive_read("dds_tpu", key))
    assert ref_at_quorum == broadcast(flipped(key))
    port_at_quorum, port_after = asyncio.run(drive_read("dds_tpu_torch", key))
    assert port_at_quorum == [] and port_after == broadcast(key)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replies_for_the_requested_key_complete_the_quorum_in_both(pkg, key):
    """Without a flipped reply both coordinators write at the quorum: the
    check costs the uncorrupted path nothing."""
    m, net, cfg, node = coordinator(pkg)

    async def go():
        sig = m.sigs.proxy_signature(cfg.proxy_mac_secret, key, NONCE, VALUE)
        await node.handle("proxy", m.M.Envelope(m.M.IWrite(key, VALUE), NONCE, sig))
        for sender in ADDRS[1:QUORUM + 1]:
            tag = m.M.ABDTag(3, sender)
            tsig = m.sigs.abd_signature(cfg.abd_mac_secret, None, tag, NONCE)
            await node.handle(sender, m.M.TagReply(tag, key, None, tsig, NONCE))

    asyncio.run(go())
    ws = writes(m, net)
    assert [w.key for w in ws] == broadcast(key)
    assert ws[0].tag == m.M.ABDTag(4, ADDRS[0]) and ws[0].value == VALUE
