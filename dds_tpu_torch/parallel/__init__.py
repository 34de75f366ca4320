"""Placement and partial-product helpers shared by the resident plane,
Stratum and (later) the sharded scatter paths."""
