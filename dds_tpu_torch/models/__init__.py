"""Crypto models of the port: the six schemes, their keys, the HE provider
(`facade.HomoProvider`) and the fold/modexp backends."""
