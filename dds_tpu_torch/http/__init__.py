"""REST surface of the port: the tiny HTTP server/client and the proxy."""
