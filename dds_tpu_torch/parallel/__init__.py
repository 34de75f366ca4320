"""The device mesh: sharded folds and modexp over a list of torch devices,
group placement, and the exact partial-product combine shared by the
resident plane, Stratum, the sharded proxy's scatter fold and Prism's
per-group scatter."""

from dds_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    sharded_pow_mod,
    sharded_reduce_mul,
)
