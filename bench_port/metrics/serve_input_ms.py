"""serve_input_ms: per traced request, the time `ServingBundle.call` spent
copying the caller's host arrays onto the device (`serving.py` `_Copy.input`,
the program spans `sh:serve.input` inside the benchmark's `request/...`
span), mean ms.  Silent where the program records no such span."""

from __future__ import annotations

from bisect import bisect_left


def per_request_ms(tr, named) -> float | None:
    """The mean over the traced requests of the wall time of the program
    spans (`tr.host`, names starting "sh:") for which `named(name)` holds
    that lie inside each request's span, in ms; None where there is no
    request or no such span."""
    reqs = [(s, e) for n, s, e in tr.spans if n.startswith("request/")]
    prog = sorted((s, e) for n, s, e in tr.host
                  if n.startswith("sh:") and named(n))
    if not reqs or not prog:
        return None
    starts = [s for s, _e in prog]
    total = 0.0
    for lo, hi in reqs:
        i = bisect_left(starts, lo)
        while i < len(prog) and prog[i][0] <= hi:
            if prog[i][1] <= hi:
                total += prog[i][1] - prog[i][0]
            i += 1
    return total / len(reqs) * 1e3


def read(ctx):
    return per_request_ms(ctx.traced, lambda n: n == "sh:serve.input")
