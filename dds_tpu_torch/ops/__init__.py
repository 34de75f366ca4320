"""Limb arithmetic: host conversions, the plain PyTorch Montgomery path and
the CUDA Montgomery-multiply kernel's wrapper."""
