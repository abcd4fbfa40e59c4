"""Serving cells: the edits of `Editor.run_demo` sent through
`ServingBundle.call` by one closed-loop caller with no think time.

The traffic file lists the edits in the demo's order, each as the encodes
it makes (the source meshes, and the donors: the batch rolled by one) and
the latent edit that turns their outputs into the decode's inputs, and
the batch sizes the demos run at, one demo each in turn.  Set-up exports
a bundle from weights the benchmark makes from the seed, loads it, and
calls each (artifact, batch) the traffic uses twice, which warms it up
and captures its graph.  The window runs demos until `seconds` have
passed; each request is timed from the host arrays handed to `call` to
its outputs back in host memory.  A sample of the edits served in the
window, drawn from the seed and holding every (edit, batch), is kept with
its outputs; after the window each edit is also run eagerly once a
batch, and the plain reference computes the same edits from the same
meshes: its own encodes, the same latent edit, its own decode.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from .. import checks
from ..reference import model as M
from ..reference.constants import PART_LIST
from ..reference.train import normalise
from ..trace import Traced, span, traced
from . import common as C


def demos(traffic: dict, n_pool: int):
    """Endless (batch, start, edit): the demo's edits in order, one demo
    at each of the traffic's batch sizes in turn, each demo on the next
    slice of the pool."""
    i = 0
    while True:
        for b in traffic["batches"]:
            start = (i * 17) % (n_pool - b + 1)
            for e in traffic["edits"]:
                yield b, start, e
            i += 1


def inputs(config: dict, traffic: dict, seed: int, h, device) -> dict:
    """The request pool: normalised meshes with their dummy row."""
    jreg = torch.as_tensor(h.j_regressor, dtype=torch.float32, device=device)
    verts = normalise(h.meshes(traffic["pool"], seed, device), jreg)
    return {"verts": verts.cpu().numpy()}


def meshes(traffic: dict, pool: dict, b: int, start: int, e: dict) -> list:
    """The host arrays of an edit's encodes: the source batch, and the
    donors (the batch rolled as the demo rolls it)."""
    src = pool["verts"][start:start + b]
    roll = {"source": 0, "donor": traffic["donor_shift"]}
    return [np.ascontiguousarray(np.roll(src, roll[w], axis=0))
            for w in e["encode"]]


def edit_latents(e: dict, encoded: list) -> tuple:
    """The edit's latent step, as the Editor's edit ops take it, on the
    encodes' outputs ((z, z_kps, ...) each, numpy): -> (z, z_kps) for the
    decode."""
    z, z_kps = encoded[0][0], encoded[0][1]
    op = e["latent"]
    if op == "same":
        return z, z_kps
    if op == "scale_parts":
        idx = [PART_LIST.index(p) for p in e["parts"]]
        z = z.copy()
        z[:, idx, :] = z[:, idx, :] * np.float32(e["factor"])
        return z, z_kps
    if op == "style":
        donor = encoded[1][0]
        norm = np.linalg.norm(z, axis=-1, keepdims=True)
        unit = donor / (np.linalg.norm(donor, axis=-1, keepdims=True)
                        + np.float32(1e-12))
        return (norm * unit).astype(np.float32), z_kps
    raise ValueError(f"no latent edit {op!r}")


def _host(out) -> tuple:
    out = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(o.cpu().numpy() for o in out)


def run_edit(call, traffic: dict, pool: dict, b: int, start: int,
             e: dict) -> list:
    """One edit through `call(artifact, *arrays)`: its encodes, then the
    decode of the edited latents -> [(artifact, outputs)] in order."""
    done = [("encode", call("encode", x))
            for x in meshes(traffic, pool, b, start, e)]
    z, z_kps = edit_latents(e, [out for _a, out in done])
    done.append(("decode", call("decode", z, z_kps)))
    return done


def export(config: dict, h, seed: int, device, wd: str, model_over=None):
    """(bundle directory, the weights): the configuration's PartAE with
    weights made from the seed, exported."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.serving import export_inference
    from semantichuman_torch.topology import MeshHierarchy
    from ..synth import make_params

    hier = MeshHierarchy.load(str(C.topology_path(config)))
    mcfg = ModelConfig(**{**config["model"], **(model_over or {})})
    model = build_model(mcfg, hier, h.part_dict, device=device)
    like = model.init(0)
    params = make_params(like, seed, device)
    out = os.path.join(wd, "bundle")
    export_inference(model, params, h.j_regressor, out)
    return out, params


class Reference:
    """The plain reference's serving programs, from the same weights and
    files as the bundle."""

    def __init__(self, config, h, params, device):
        C.no_tf32()
        self.model = C.reference_model(config, h, device)
        self.jreg = torch.as_tensor(h.j_regressor, dtype=torch.float32,
                                    device=device)
        self.params, self.device = params, device

    def __call__(self, art: str, *arrays) -> tuple:
        a = [torch.as_tensor(x, device=self.device) for x in arrays]
        with torch.no_grad():
            if art == "decode":
                dummy = a[0].new_zeros((a[0].shape[0], 1, self.model.enc_c))
                res = (self.model.decode(self.params, a[0], a[1],
                                         dummy)[:, :-1],)
            else:
                kps = M.keep_kps(M.regress(self.jreg, a[0][:, :-1]))
                res = (self.model.forward(self.params, a[0], kps)
                       if art == "forward"
                       else self.model.encode(self.params, a[0], kps))
        return tuple(r.cpu().numpy() for r in res)


def gap(served: list, refs: list) -> float:
    """The worst output of every request of the edits: max |out - ref|
    over max |ref|."""
    return max(checks.output_gap(p, r)
               for done, ref in zip(served, refs)
               for (_a, got), (_r, want) in zip(done, ref)
               for p, r in zip(got, want))


def reference_edits(ref: Reference, traffic: dict, pool: dict,
                    samples: list) -> list:
    """The reference's run of each sampled (batch, start, edit, ...)."""
    return [run_edit(ref, traffic, pool, b, start, e)
            for b, start, e, _done in samples]


def run(cell: str, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, limits: dict) -> dict:
    from semantichuman_torch.serving import ServingBundle

    marks = [("imported", time.perf_counter())]
    h = C.human(config)
    wd = C.workdir(cell)
    bundle_dir, params = export(config, h, seed, device, wd)
    marks.append(("exported", time.perf_counter()))
    bundle = ServingBundle(bundle_dir, device=device)
    marks.append(("loaded", time.perf_counter()))
    pool = inputs(config, traffic, seed, h, device)
    edits = traffic["edits"]
    for b in traffic["batches"]:
        for _ in range(2):
            run_edit(lambda art, *a: _host(bundle.call(art, *a)), traffic,
                     pool, b, 0, edits[0])
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    marks.append(("captured", time.perf_counter()))
    # the window: one caller, the next request as soon as the last returned
    rng = random.Random(seed + 1)
    keep = traffic["sample_per_kind"]
    kinds = [(e["name"], b) for e in edits for b in traffic["batches"]]
    samples: dict = {k: [] for k in kinds}
    seen: dict = {k: 0 for k in kinds}
    lat, served = [], []
    tr = Traced() if trace else None
    n_traced = traffic["traced_requests"] if trace else 0
    gen = demos(traffic, len(pool["verts"]))

    def timed(art, *args):
        t0 = time.perf_counter()
        with span(f"request/{art}/{len(args[0])}"):
            got = _host(bundle.call(art, *args))
        lat.append(time.perf_counter() - t0)
        served.append((art, len(args[0])))
        return got

    def serve():
        b, start, e = next(gen)
        done = run_edit(timed, traffic, pool, b, start, e)
        k = (e["name"], b)
        seen[k] += 1
        if len(samples[k]) < keep:
            samples[k].append((b, start, e, done))
        else:
            j = rng.randrange(seen[k])
            if j < keep:
                samples[k][j] = (b, start, e, done)

    if tr is not None:
        # the traced stretch: the first requests, profiled, before the
        # window
        with traced(tr):
            while len(lat) < n_traced:
                serve()
        lat.clear()
        served.clear()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        serve()
    window_s = time.perf_counter() - t_start
    out = {"window_start": t_start, "marks": marks,
           "window_s": window_s, "latencies": lat, "served": served,
           "traced": tr, "meshes": sum(b for _a, b in served)}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    flat = [s for k in kinds for s in samples[k]]
    eager = [(b, 0, e, run_edit(
        lambda art, *a: _host(bundle.call(art, *a, graph=False)), traffic,
        pool, b, 0, e)) for e in edits for b in traffic["batches"]]
    del bundle
    C.free(device)
    ref = Reference(config, h, params, device)
    nums = {"serve_gap": gap([d for *_x, d in flat],
                             reference_edits(ref, traffic, pool, flat)),
            "eager_gap": gap([d for *_x, d in eager],
                             reference_edits(ref, traffic, pool, eager))}
    out["checks"] = checks.judge(nums, limits)
    return out
