"""The replicated core of the port: BFT-ABD replicas, quorum client,
messages and the in-memory transport (trimmed copies of `dds_tpu/core`)."""
