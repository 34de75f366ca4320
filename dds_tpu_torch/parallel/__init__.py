"""Placement and partial-product helpers shared by the resident plane,
Stratum, the sharded proxy's scatter fold and Prism's per-group scatter."""
