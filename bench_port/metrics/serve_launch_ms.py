"""serve_launch_ms: per traced request, the time `ServingBundle.call` spent
launching the program (`serving.py` `_Copy.call`: the copies into the static
inputs, the graph's replay and the output clones, or the eager program), from
the program spans `sh:serve.copy_in`, `sh:replay/serve/...`,
`sh:serve.clone` and `sh:serve.eager` inside the benchmark's `request/...`
span, mean ms.  Silent where the program records no such span."""

from __future__ import annotations

import importlib.util

from bench_port.manifest import HERE

LAUNCH = ("sh:serve.copy_in", "sh:serve.clone", "sh:serve.eager")


def _serve_input():
    """The reader module of `serve_input_ms`, whose `per_request_ms` this
    metric shares."""
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_serve_input_ms",
        HERE / "metrics" / "serve_input_ms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launched(name: str) -> bool:
    return name in LAUNCH or name.startswith("sh:replay/serve/")


def read(ctx):
    return _serve_input().per_request_ms(ctx.traced, launched)
