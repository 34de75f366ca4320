"""Scheme facade: per-column encrypt/decrypt by scheme tag.

Copy of `dds_tpu/models/facade.py`, the client-side analogue of the
reference's `SJHomoLibProvider` trait (`utils/SJHomoLibProvider.scala:
53-101`): dispatch on the six scheme tags plus the `"Plain"` null cipher,
and whole-row encrypt/decrypt against a column-schema list (the variable
part is `row[until:]`, nothing past the end).

PSSE bulk decryption (`decrypt_rows`) runs on the Sanctum
secret-material plane: host-only unless the provider carries a
device-posture `secret_backend` (`sanctum.SecretBackend`).

Ciphertext wire types (JSON-safe):
  OPE -> int, PSSE/MSE -> decimal string, CHE/LSE/None -> base64 string.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dds_tpu_torch.models.keys import HEKeys

SCHEME_TAGS = ("OPE", "LSE", "CHE", "PSSE", "MSE", "None")

# Canonical 8-column schema documented at clt/DDSDataGenerator.scala:11-23
# and configured in client.conf:50-61.
DEFAULT_SCHEMA = ["OPE", "CHE", "PSSE", "MSE", "CHE", "CHE", "CHE", "None"]


@dataclass(frozen=True)
class HomoProvider:
    keys: HEKeys
    # DJN short-exponent obfuscators for PSSE encryption (see
    # PaillierPublicKey.blind_fast): ~5x cheaper per ciphertext on the
    # client. False = textbook full-width r^n.
    fast_blinding: bool = True
    # Bulk-ENCRYPTION accelerator (a models.backend.CryptoBackend): when
    # set, precompute_psse_blinds routes the full-width r^n obfuscator
    # modexps through backend.powmod_batch and PSSE encrypts drain the
    # pool — each ciphertext still gets its own fresh full-width
    # obfuscator (textbook blinding), only the modexp moves off the host
    # hot loop. Encrypt-only: r^n needs public parameters alone.
    bulk_backend: object = None
    # Sanctum handle (dds_tpu_torch.sanctum.SecretBackend) for the PSSE
    # decrypt CRT legs: None = host-only (the default posture); a
    # device-posture handle is the explicit `[crypto] secret-device`
    # opt-in. Anything else raises at decrypt_rows, in decrypt_batch.
    secret_backend: object = None
    # obfuscators precomputed by the bulk backend; one provider may serve
    # many clients, and every pop hands out a distinct obfuscator
    _blind_pool: list = field(default_factory=list, repr=False, compare=False)

    @staticmethod
    def generate(paillier_bits: int = 2048, rsa_bits: int = 1024,
                 fast_blinding: bool = True) -> "HomoProvider":
        return HomoProvider(
            HEKeys.generate(paillier_bits, rsa_bits), fast_blinding=fast_blinding
        )

    def precompute_psse_blinds(self, count: int, min_batch: int = 64) -> int:
        """Fill the obfuscator pool for `count` upcoming PSSE encrypts via
        the bulk backend's batched modexp; no-op (returns 0) without a
        backend or below the amortization threshold — per-op paths are
        faster there."""
        if self.bulk_backend is None or count < min_batch:
            return 0
        self._blind_pool.extend(
            self.keys.psse.public.blind_batch(count, self.bulk_backend, min_batch)
        )
        return count

    def _pooled_blind(self) -> int | None:
        try:
            return self._blind_pool.pop()  # atomic: no two callers share one
        except IndexError:
            return None

    def encrypt(self, value, tag: str):
        k = self.keys
        match tag:
            case "OPE":
                return k.ope.encrypt(int(value))
            case "LSE":
                return k.lse.encrypt(str(value))
            case "CHE":
                return k.che.encrypt(str(value))
            case "PSSE":
                rn = self._pooled_blind()
                if rn is not None:  # precomputed batch obfuscator
                    return str(k.psse.public.encrypt(int(value), rn=rn))
                if self.fast_blinding:
                    return str(k.psse.public.encrypt_fast(int(value)))
                return str(k.psse.public.encrypt(int(value)))
            case "MSE":
                return str(k.mse.public.encrypt(int(value)))
            case "None":
                return k.none.encrypt(str(value))
            case "Plain":
                # null cipher: deterministic passthrough for AES-less hosts
                # (the reference's canary rule when `cryptography` is
                # absent) — synthetic plaintexts only, never user data
                return str(value)
        raise ValueError(f"unknown scheme tag {tag!r}")

    def decrypt(self, value, tag: str):
        k = self.keys
        match tag:
            case "OPE":
                return k.ope.decrypt(int(value))
            case "LSE":
                return k.lse.decrypt(str(value))
            case "CHE":
                return k.che.decrypt(str(value))
            case "PSSE":
                return k.psse.decrypt_signed(int(value))
            case "MSE":
                return k.mse.decrypt(int(value))
            case "None":
                return k.none.decrypt(str(value))
            case "Plain":
                return str(value)
        raise ValueError(f"unknown scheme tag {tag!r}")

    def encrypt_row(self, row: list, until: int, schema: list[str]) -> list:
        """Encrypt row[:until] per-column by schema, the rest with "None"."""
        fixed = [self.encrypt(v, schema[i]) for i, v in enumerate(row[:until])]
        variable = [self.encrypt(v, "None") for v in row[until:]]
        return fixed + variable

    def decrypt_row(self, row: list, until: int, schema: list[str]) -> list:
        fixed = [self.decrypt(v, schema[i]) for i, v in enumerate(row[:until])]
        variable = [self.decrypt(v, "None") for v in row[until:]]
        return fixed + variable

    def decrypt_rows(self, rows: list[list], until: int, schema: list[str],
                     min_batch: int = 64) -> list[list]:
        """Bulk decrypt_row. All rows' PSSE columns decrypt as ONE batched
        CRT pass on the Sanctum plane (`PaillierKey.decrypt_batch`, with
        this provider's `secret_backend`): host-only unless that handle is
        device-posture. The public bulk backend is encrypt-only and never
        sees the decrypt legs; the other schemes are per-op host work."""
        cols = sorted(i for i, s in enumerate(schema[:until]) if s == "PSSE")
        cts = [int(r[i]) for r in rows for i in cols if i < len(r)]
        if len(cts) < min_batch:
            return [self.decrypt_row(r, until, schema) for r in rows]
        k = self.keys.psse
        psse_cols = set(cols)
        plains = iter(k.decrypt_batch(cts, backend=self.secret_backend,
                                      min_batch=min_batch))
        out = []
        for r in rows:
            dec = []
            for i, v in enumerate(r[:until]):
                if i in psse_cols:
                    dec.append(k.to_signed(next(plains)))
                else:
                    dec.append(self.decrypt(v, schema[i]))
            dec.extend(self.decrypt(v, "None") for v in r[until:])
            out.append(dec)
        return out
