"""Command-line probes of the port: the conv probe and the stream probe."""
