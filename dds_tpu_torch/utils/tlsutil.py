"""Mutual-TLS plumbing: cert generation and SSLContext builders.

Copy of `dds_tpu/utils/tlsutil.py`. The reference runs mutual TLS on every
hop (client to proxy, proxy to replica, replica to replica) from keystores
with an accept-all hostname verifier. Here the same posture is explicit:
`generate_ca_and_cert` writes a PEM CA and a host cert (idempotent; the
private keys are born 0600), and the context builders default to mutual
auth with hostname verification off, the reference's default, which a
config can turn on.
"""

from __future__ import annotations

import datetime
import ipaddress
import pathlib
import ssl


def generate_ca_and_cert(
    directory: str | pathlib.Path,
    common_name: str = "dds-node",
    hosts: tuple[str, ...] = ("127.0.0.1", "localhost"),
    days: int = 365,
) -> dict[str, pathlib.Path]:
    """Create ca.pem / cert.pem / key.pem under `directory` (idempotent)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "ca": d / "ca.pem",
        "ca_key": d / "ca.key.pem",
        "cert": d / "cert.pem",
        "key": d / "key.pem",
    }
    if all(p.exists() for p in paths.values()):
        return paths

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "dds-ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    key = ec.generate_private_key(ec.SECP256R1())
    alt_names = []
    for h in hosts:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            alt_names.append(x509.DNSName(h))
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(alt_names), critical=False)
        .sign(ca_key, hashes.SHA256())
    )

    pem = serialization.Encoding.PEM
    nokey = serialization.NoEncryption()

    def _write_private(path: pathlib.Path, data: bytes) -> None:
        path.touch(mode=0o600, exist_ok=True)
        path.chmod(0o600)
        path.write_bytes(data)

    paths["ca"].write_bytes(ca_cert.public_bytes(pem))
    _write_private(
        paths["ca_key"],
        ca_key.private_bytes(pem, serialization.PrivateFormat.PKCS8, nokey),
    )
    paths["cert"].write_bytes(cert.public_bytes(pem))
    _write_private(
        paths["key"],
        key.private_bytes(pem, serialization.PrivateFormat.PKCS8, nokey),
    )
    return paths


def server_context(
    cert: str | pathlib.Path,
    key: str | pathlib.Path,
    ca: str | pathlib.Path | None = None,
    require_client_cert: bool = True,
) -> ssl.SSLContext:
    """TLS server context; mutual auth when a CA is given (the default
    posture everywhere in the reference)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(str(cert), str(key))
    if ca is not None:
        ctx.load_verify_locations(str(ca))
        if require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(
    ca: str | pathlib.Path,
    cert: str | pathlib.Path | None = None,
    key: str | pathlib.Path | None = None,
    verify_hostname: bool = False,
) -> ssl.SSLContext:
    """TLS client context trusting `ca`; presents a client cert when given.

    verify_hostname defaults to False — the reference disables hostname
    verification globally because cert CNs don't match lab IPs
    (`DDSInsecureHostnameVerifier`); we make the same default explicit
    and reversible."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_verify_locations(str(ca))
    ctx.check_hostname = verify_hostname
    if cert is not None and key is not None:
        ctx.load_cert_chain(str(cert), str(key))
    return ctx
