"""Prism: the encrypted analytics plane (plaintext-matrix x
ciphertext-vector products over Paillier, served as REST routes). See
prism.py."""

from dds_tpu_torch.analytics.prism import Prism  # noqa: F401
