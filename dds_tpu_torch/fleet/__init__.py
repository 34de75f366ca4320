"""Fleet-level control loops: the planes that steer the whole
constellation rather than one group — the Helmsman autoscaler
(fleet/helmsman.py). Port of `dds_tpu/fleet/`."""

from dds_tpu_torch.fleet.helmsman import Helmsman  # noqa: F401
