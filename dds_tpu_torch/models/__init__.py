"""Crypto models of the port: Paillier (PSSE) and the fold backends."""
