"""Client harness of the port: instruction set, benchmark client and the
workload generator."""

from dds_tpu_torch.clt.client import ClientConfig, DDSHttpClient  # noqa: F401
from dds_tpu_torch.clt.instructions import Digest  # noqa: F401
