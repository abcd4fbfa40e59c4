"""serve_host_gap_ms: `layers.serve_host_gap_ms`, read in the serving cells."""

from bench_port.layers import serve_host_gap_ms as read  # noqa: F401
