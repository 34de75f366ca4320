"""Client harness of the port: instruction set and the benchmark client."""

from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient  # noqa: F401
from dds_tpu_torch.clt.instructions import Digest  # noqa: F401
