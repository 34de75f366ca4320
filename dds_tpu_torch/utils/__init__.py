"""Host utilities of the port: config, tracing, signatures, trust, retry."""
