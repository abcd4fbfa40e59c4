"""One rank of the port's data-parallel training step on the CPU (gloo),
for tests/test_torch_parallel.py.

Reads a case pickle the test wrote (the hierarchy file, the model
overrides, the small human's faces, J_regressor and part dict, the JAX
initial parameters as numpy, three global batches of each segment, the
edit spec, the per-term gradient cases), joins a gloo group of --world
processes at tcp://localhost:--port, and on its rows of every global
batch:

  * runs make_train_step(data_parallel=True) for three steps (the
    metrics, global values, and the final parameters);
  * for each gradient case, the all-reduced gradient of one loss term.

Writes the pickle --out: {"metrics": [...], "params": numpy tree,
"grads": {case: [leaves]}}.
"""

import argparse
import dataclasses
import os
import pickle
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.parallel.distributed import (
        initialize_distributed)
    from semantichuman_torch.parallel.mesh import (all_reduce_grads,
                                                   shard_batch, shard_spec)
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train import losses as L
    from semantichuman_torch.train.optim import make_optimizer
    from semantichuman_torch.train.step import (StepFlags, make_loss_fn,
                                                make_train_step,
                                                to_device, value_and_grad)
    from semantichuman_torch.utils.params import (params_from_jax,
                                                  params_to_numpy,
                                                  tree_leaves)

    with open(args.case, "rb") as f:
        case = pickle.load(f)
    initialize_distributed(f"tcp://localhost:{args.port}", args.world,
                           args.rank, device="cpu")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    model = build_model(
        ModelConfig(**{k: v for k, v in case["model"].items()
                       if k in fields}),
        MeshHierarchy.load(case["hier"]), case["part_dict"], device="cpu")
    tables = L.build_loss_tables(case["faces"], case["j_regressor"],
                                 case["part_dict"], device="cpu")
    opt = make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)

    def local(batch):
        return to_device(shard_batch(batch), "cpu")

    spec = to_device(shard_spec(case["spec"]), "cpu")
    params = params_from_jax(case["params"], "cpu")
    opt_state = opt.init(params)
    step = make_train_step(model, tables, opt, StepFlags(), "ori",
                           data_parallel=True)
    metrics = []
    for batch, interp, exc in case["steps"]:
        params, opt_state, m = step(params, opt_state, local(batch),
                                    local(interp), local(exc), spec)
        metrics.append({k: float(v) for k, v in m.items()})

    grads = {}
    batch, interp, exc = (local(b) for b in case["steps"][0])
    params0 = params_from_jax(case["params"], "cpu")
    for name, (flags, variant, term, spec_over) in case["grad_cases"].items():
        loss_fn = make_loss_fn(model, tables, StepFlags(**flags), variant,
                               data_parallel=True)

        def term_fn(p, *a, _fn=loss_fn, _term=term):
            _, ms = _fn(p, *a)
            return ms[_term], ms

        sp = to_device(shard_spec({**case["spec"], **spec_over}), "cpu")
        _, _, g = value_and_grad(term_fn, params0, batch, interp, exc, sp)
        grads[name] = [t.numpy() for t in all_reduce_grads(tree_leaves(g))]

    with open(args.out, "wb") as f:
        pickle.dump({"metrics": metrics, "params": params_to_numpy(params),
                     "grads": grads}, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
