"""Training cells: the recipe driven through `Trainer.fit`, as users train.

Set-up builds one Trainer from the benchmark's inputs (meshes, assets and
weights made from the seed), drives it through epoch 1 (its first steps
through the window's own call and feed: the captured epoch path, or the
loop where the recipe takes it; the capture, the kernels' first launches
and validation's warm-up happen there), and keeps what the optimizer held
after step 1 and the parameters after step 3.  The window hands the same
Trainer whole-epoch calls (up to the next validation) until `seconds` have
passed.  After it, the plain reference follows the first three steps from
the same weights and inputs, and `checks.train_numbers` compares.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks
from ..reference import train as R
from ..trace import Traced, span, traced
from . import common as C


def _trainer(config: dict, traffic: dict, seed: int, device, name: str,
             model_over: dict | None = None):
    """(Trainer, its inputs): the meshes, measures and weights of `seed`."""
    from semantichuman_torch.config import Config
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.data.dataset import ArraySource
    from semantichuman_torch.topology.adjacency import unique_edges
    from semantichuman_torch.train.loop import Trainer
    from ..synth import make_params

    h = C.human(config)
    verts = h.meshes(traffic["n_train"], seed, device)
    test = h.meshes(traffic["n_test"], seed + 1, device)
    meas = h.measures(verts) if traffic["data"].get("measure", True) else None
    cfg = Config.from_dict({
        "model": {**config["model"], **(model_over or {})},
        "train": {**traffic["train"], "seed": int(seed)},
        "data": traffic["data"]})
    wd = C.workdir(name)
    assets = BodyAssets(
        template_verts=h.template_verts, template_faces=h.template_faces,
        j_regressor=h.j_regressor, part_dict=h.part_dict,
        girth_edges=h.girth_edges, girth_factors=h.girth_factors,
        edge_verts=unique_edges(h.template_faces))
    test_np = test.cpu().numpy()
    data = {"train": ArraySource(verts.cpu().numpy(),
                                 None if meas is None else meas.cpu().numpy()),
            "val": ArraySource(test_np), "test": ArraySource(test_np)}
    C.seed_topology(config, wd)
    trainer = Trainer(cfg, wd, assets=assets, data=data, device=device)
    if list(trainer.hierarchy.sizes) != _sizes(config):
        raise RuntimeError("the Trainer's hierarchy is not the configuration's")
    params = make_params(trainer.params, seed, device)
    trainer.params = C.rebuild(params, [p.clone() for p in C.leaves(params)])
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    return trainer, {"human": h, "verts": verts, "measures": meas,
                     "params": params}


def _sizes(config):
    with np.load(C.topology_path(config), allow_pickle=False) as z:
        return [len(z[f"verts_{l}"]) for l in range(int(z["n_levels"]))]


def first_epoch(trainer, n: int = 3) -> dict:
    """trainer.fit(1), observing the first n steps of the window's own
    call: -> {"loss": [n], "mu1": Adam's first moments after step 1,
    "params_n": the parameters after step n} (lists of leaves)."""
    seen = {"k": 0}
    scan = trainer._epoch_scan_ok()
    name = "_get_scan_step" if scan else "_get_step"
    orig = getattr(trainer, name)

    def after(params, mu, metrics_row):
        seen["k"] += 1
        if seen["k"] == 1:
            seen["mu1"] = [m.detach().clone() for m in mu]
        if seen["k"] <= n and metrics_row is not None:
            seen.setdefault("loss", []).append(metrics_row.clone())
        if seen["k"] == n:
            seen["params_n"] = [p.detach().clone() for p in params]

    def observed(epoch, variant):
        got = orig(epoch, variant)
        if scan:
            run, step = got
            buf = trainer._epoch_buffers

            def run_seen():
                run()
                k = seen["k"]
                row = None
                if k < n:
                    col = step.metric_names.index("loss")
                    row = buf.metrics[k, col]
                after(buf.leaves, buf.mu, row)
            return run_seen, step

        def step_seen(params, opt_state, *args):
            out = got(params, opt_state, *args)
            after(C.leaves(out[0]), out[1].mu, out[2]["loss"])
            return out
        return step_seen

    setattr(trainer, name, observed)
    try:
        trainer.fit(1)
    finally:
        delattr(trainer, name)
    return {"loss": [float(x) for x in seen["loss"]], "mu1": seen["mu1"],
            "params_n": seen["params_n"]}


def program_readings(first: dict, params0: list) -> dict:
    """Per leaf: the first gradient as Adam took it in (its first moment
    over 1 - b1), and the parameters' change after the observed steps."""
    return {"loss": first["loss"],
            "grad": [float(torch.linalg.vector_norm(m)) / 0.1
                     for m in first["mu1"]],
            "delta": [float(torch.linalg.vector_norm(p - p0))
                      for p, p0 in zip(first["params_n"], params0)]}


def reference_readings(config, traffic, inputs, device, n: int = 3,
                       rows=None) -> dict:
    C.no_tf32()
    h = inputs["human"]
    model = C.reference_model(config, h, device)
    tab = R.LossTables(h.template_faces, h.part_dict, device)
    jreg = torch.as_tensor(h.j_regressor, dtype=torch.float32, device=device)
    params = inputs["params"]
    return R.follow(model, C.leaves(params), lambda fl: C.rebuild(params, fl),
                    tab, jreg, inputs["verts"], inputs["measures"],
                    traffic["train"], int(inputs["seed"]), n,
                    part_model=config["model"]["model_type"] != "neural3DMM",
                    rows=rows, normalization=traffic["data"]["normalization"])


def _next_end(trainer, e0: int) -> int:
    """The last epoch of the call that starts at e0: the next validation
    epoch, at most scan_epochs on."""
    t = trainer.cfg.train
    v = max(t.val_every, 1)
    return min(((e0 - 1) // v + 1) * v, e0 + max(t.scan_epochs, 1) - 1)


def run(cell: str, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, limits: dict) -> dict:
    """One run of a training cell: -> the driver's result pieces."""
    marks = [("imported", time.perf_counter())]
    trainer, inputs = _trainer(config, traffic, seed, device, cell)
    marks.append(("built", time.perf_counter()))
    inputs["seed"] = seed
    params0 = C.leaves(inputs["params"])
    first = first_epoch(trainer)
    marks.append(("epoch 1", time.perf_counter()))
    prog = program_readings(first, params0)
    del first
    t = trainer.cfg.train
    per_epoch = trainer.steps_per_epoch * t.batch_train
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    e = 2
    tr = traced_call = None
    if trace:
        # the traced stretch: one call, profiled, before the window
        tr = Traced()
        end = _next_end(trainer, e)
        trainer.start_epoch = e
        c0 = time.perf_counter()
        with traced(tr):
            _fit(trainer, end)
        traced_call = (e, end, time.perf_counter() - c0)
        e = end + 1
    # the window: whole-epoch calls until `seconds` have passed
    calls = []
    t_start = time.perf_counter()
    while True:
        end = _next_end(trainer, e)
        trainer.start_epoch = e
        c0 = time.perf_counter()
        _fit(trainer, end)
        calls.append((e, end, time.perf_counter() - c0))
        e = end + 1
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    history = [h for h in trainer.history if h["epoch"] >= calls[0][0]]
    out = {"window_start": t_start, "marks": marks, "window_s": window_s,
           "history": history, "calls": calls, "traced_call": traced_call,
           "meshes": sum((b - a + 1) for a, b, _ in calls) * per_epoch,
           "steps_per_epoch": trainer.steps_per_epoch,
           "trunk_b": t.batch_train + (2 * t.batch_interp
                                       if trainer.is_part_model else 0),
           "batch_test": t.batch_test, "traced": tr}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    del trainer
    C.free(device)
    ref = reference_readings(config, traffic, inputs, device)
    nums = checks.train_numbers(prog, ref)
    out["checks"] = checks.judge(nums, limits)
    out["readings"] = {**nums, "loss": prog["loss"], "loss_ref": ref["loss"],
                       "epoch_s": [h["sec"] for h in history]}
    return out


def _fit(trainer, end: int):
    """Trainer.fit to epoch `end`, validation within a span of its own."""
    val = trainer.validate

    def validate():
        with span("validate"):
            return val()

    trainer.validate = validate
    try:
        with span("fit"):
            trainer.fit(end)
    finally:
        del trainer.validate
