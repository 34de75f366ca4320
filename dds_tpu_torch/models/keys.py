"""Key material for all six schemes, with a stable JSON serialization.

Copy of `dds_tpu/models/keys.py`, with the SAME JSON format: hex ints and
base64 bytes per scheme tag. That JSON is how a client's key material
crosses between the two packages (`convert.keys_from_reference`). Clients
are the only principals who hold these; proxies receive only public
parameters per request (Paillier n^2, RSA public key).
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass

from dds_tpu_torch.models._symmetric import b64d as _unb64, b64e as _b64
from dds_tpu_torch.models.det import DetKey
from dds_tpu_torch.models.mult import RsaMultKey
from dds_tpu_torch.models.ope import OpeKey
from dds_tpu_torch.models.paillier import PaillierKey
from dds_tpu_torch.models.rand import RandKey
from dds_tpu_torch.models.searchable import SearchKey


@dataclass(frozen=True)
class HEKeys:
    ope: OpeKey
    che: DetKey
    lse: SearchKey
    psse: PaillierKey
    mse: RsaMultKey
    none: RandKey

    @staticmethod
    def generate(paillier_bits: int = 2048, rsa_bits: int = 1024) -> "HEKeys":
        return HEKeys(
            ope=OpeKey(secrets.token_bytes(32)),
            che=DetKey(secrets.token_bytes(32), secrets.token_bytes(32)),
            lse=SearchKey(secrets.token_bytes(32), secrets.token_bytes(32)),
            psse=PaillierKey.generate(paillier_bits),
            mse=RsaMultKey.generate(rsa_bits),
            none=RandKey(secrets.token_bytes(32)),
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "OPE": {"key": _b64(self.ope.key)},
                "CHE": {"k_enc": _b64(self.che.k_enc), "k_mac": _b64(self.che.k_mac)},
                "LSE": {"k_enc": _b64(self.lse.k_enc), "k_tag": _b64(self.lse.k_tag)},
                "PSSE": {"n": hex(self.psse.n), "p": hex(self.psse.p), "q": hex(self.psse.q)},
                "MSE": {
                    "n": hex(self.mse.n),
                    "e": hex(self.mse.e),
                    "d": hex(self.mse.d),
                    "p": hex(self.mse.p),
                    "q": hex(self.mse.q),
                },
                "None": {"key": _b64(self.none.key)},
            }
        )

    @staticmethod
    def from_json(blob: str) -> "HEKeys":
        d = json.loads(blob)
        return HEKeys(
            ope=OpeKey(_unb64(d["OPE"]["key"])),
            che=DetKey(_unb64(d["CHE"]["k_enc"]), _unb64(d["CHE"]["k_mac"])),
            lse=SearchKey(_unb64(d["LSE"]["k_enc"]), _unb64(d["LSE"]["k_tag"])),
            psse=PaillierKey(
                n=int(d["PSSE"]["n"], 16), p=int(d["PSSE"]["p"], 16), q=int(d["PSSE"]["q"], 16)
            ),
            mse=RsaMultKey(
                n=int(d["MSE"]["n"], 16),
                e=int(d["MSE"]["e"], 16),
                d=int(d["MSE"]["d"], 16),
                p=int(d["MSE"]["p"], 16),
                q=int(d["MSE"]["q"], 16),
            ),
            none=RandKey(_unb64(d["None"]["key"])),
        )
