"""Import reference PyTorch checkpoints into the port's parameters (the
counterpart of `semantichuman_tpu/utils/import_torch.py`).

The reference saves `{epoch, autoencoder_state_dict, optimizer_state_dict,
scheduler_state_dict}` in `.pth.tar` files (train_funcs.py:450-455).  This
module maps `autoencoder_state_dict` onto the port's parameter tree, and
for a training resume the torch Adam moments onto the port's `AdamState`.

Reference key layout (models.py:55-310):
  conv.{i}.conv.{weight,bias}             encoder SpiralConvs
  dconv.{i}.conv.{weight,bias}            decoder SpiralConvs
  fc_latent_enc_list.{p}.{weight,bias}    17 per-part shape-latent heads
  fc_latent_dec_list.{p}.{weight,bias}    17 per-part decoder heads
  kps_enc_list.{p}.{weight,bias}          17 per-part keypoint encoders
  fc_latent_enc / fc_latent_dec           neural3DMM baseline bottleneck

torch `nn.Linear.weight` is [out, in]; the port's is [in, out], so every
weight is transposed.  Per-part heads are zero-padded into the batched
[P, ...] layout; the pads multiply the zeroed dummy row (or padded zeros),
so results are unchanged.  Every output is a float32 tensor on the model's
device.  Files load with `torch.load(weights_only=True)`: a checkpoint
holds dicts, numbers and tensors only, and unpickling may not run code.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..train.optim import AdamState
from .params import params_from_jax, tree_leaves


def _np(t) -> np.ndarray:
    """torch tensor | array-like -> float32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _strip_prefix(state: dict) -> dict:
    """Drop a DataParallel-style 'module.' prefix if present."""
    if state and all(k.startswith("module.") for k in state):
        return {k[len("module."):]: v for k, v in state.items()}
    return dict(state)


def _conv_stack(state: dict, name: str, n: int) -> list:
    out = []
    for i in range(n):
        w = _np(state[f"{name}.{i}.conv.weight"]).T     # [S*C_in, C_out]
        b = _np(state[f"{name}.{i}.conv.bias"])
        out.append({"w": w, "b": b})
    return out


def import_part_ae_state(state: dict, model) -> dict:
    """Reference `SpiralAutoencoder_multiz_partkps` state dict -> PartAE
    params (model: models.part_ae.PartAE)."""
    state = _strip_prefix(state)
    params = {
        "conv": _conv_stack(state, "conv", len(model.enc_plan)),
        "dconv": _conv_stack(state, "dconv", len(model.dec_plan)),
    }
    nz, nk, c = model.latent_size, model.kps_latent_size, model.enc_out_c
    c0 = model.dec_in_c
    P, n_max, g_max = model.n_parts, model.n_max, model.g_max

    w_enc = np.zeros((P, n_max * c, nz), np.float32)
    b_enc = np.zeros((P, nz), np.float32)
    w_dec = np.zeros((P, nz + nk, n_max * c0), np.float32)
    b_dec = np.zeros((P, n_max * c0), np.float32)
    w_kps = np.zeros((P, g_max * 3, nk), np.float32)
    b_kps = np.zeros((P, nk), np.float32)
    for p in range(P):
        n_p = model.part_sizes[p]
        g_p = len(model.kps_index_list[p])
        we = _np(state[f"fc_latent_enc_list.{p}.weight"]).T   # [n_p*c, nz]
        if we.shape[0] != n_p * c:
            raise ValueError(
                f"part {p}: encoder head expects fan-in {n_p * c}, "
                f"checkpoint has {we.shape[0]} — part layout mismatch")
        w_enc[p, :n_p * c] = we
        b_enc[p] = _np(state[f"fc_latent_enc_list.{p}.bias"])
        wd = _np(state[f"fc_latent_dec_list.{p}.weight"]).T   # [nz+nk, n_p*c0]
        w_dec[p, :, :n_p * c0] = wd
        b_dec[p, :n_p * c0] = _np(state[f"fc_latent_dec_list.{p}.bias"])
        wk = _np(state[f"kps_enc_list.{p}.weight"]).T         # [g_p*3, nk]
        w_kps[p, :g_p * 3] = wk
        b_kps[p] = _np(state[f"kps_enc_list.{p}.bias"])

    params["enc_heads"] = {"w": w_enc, "b": b_enc}
    params["dec_heads"] = {"w": w_dec, "b": b_dec}
    params["kps_heads"] = {"w": w_kps, "b": b_kps}
    return params_from_jax(params, model.tables.device)


def import_spiral_ae_state(state: dict, model) -> dict:
    """Reference `SpiralAutoencoder` (neural3DMM) state dict -> SpiralAE
    params (model: models.spiral_ae.SpiralAE)."""
    state = _strip_prefix(state)
    params = {
        "conv": _conv_stack(state, "conv", len(model.enc_plan)),
        "dconv": _conv_stack(state, "dconv", len(model.dec_plan)),
        "fc_enc": {"w": _np(state["fc_latent_enc.weight"]).T,
                   "b": _np(state["fc_latent_enc.bias"])},
        "fc_dec": {"w": _np(state["fc_latent_dec.weight"]).T,
                   "b": _np(state["fc_latent_dec.bias"])},
    }
    return params_from_jax(params, model.tables.device)


def _import_fn(model):
    """The importer of the model's family (PartAE has a keypoint
    encoder)."""
    return (import_part_ae_state if hasattr(model, "kps_encode")
            else import_spiral_ae_state)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(path: str, model) -> tuple[dict, int]:
    """Load a reference `.pth.tar` checkpoint file -> (params, epoch)."""
    ckpt = _load(path)
    state = ckpt.get("autoencoder_state_dict", ckpt)
    return _import_fn(model)(state, model), int(ckpt.get("epoch", 0))


# --- optimizer / scheduler state import --------------------------------------

def _moment_dicts(opt_sd: dict, params_sd: dict):
    """torch `optim.state_dict()` -> ({name: exp_avg}, {name: exp_avg_sq},
    step_count).

    The state dict's `state` keys are integer positions in the flattened
    param_groups parameter order, which for the reference equals
    `model.parameters()` order; the reference registers no buffers, so
    that order is the key order of `autoencoder_state_dict` (`params_sd`).
    Each moment's shape is checked against its parameter's, so an order
    mismatch (custom param_groups, requires_grad filtering) raises instead
    of resuming with swapped moments."""
    state = opt_sd.get("state") or {}
    names = list(params_sd)
    exp_avg, exp_avg_sq, steps = {}, {}, []
    for idx, st in state.items():
        if int(idx) >= len(names):
            raise ValueError(
                f"optimizer state index {idx} out of range for "
                f"{len(names)} model parameters — checkpoint optimizer "
                "does not cover the model's parameter list")
        name = names[int(idx)]
        ea, eas = _np(st["exp_avg"]), _np(st["exp_avg_sq"])
        want = tuple(params_sd[name].shape)
        if ea.shape != want or eas.shape != want:
            raise ValueError(
                f"optimizer moment shape {ea.shape} does not match "
                f"parameter '{name}' shape {want} — param order mismatch "
                "between optimizer_state_dict and autoencoder_state_dict")
        exp_avg[name] = ea
        exp_avg_sq[name] = eas
        s = st.get("step", 0)
        steps.append(int(s.item() if hasattr(s, "item") else s))
    if len(set(steps)) > 1:
        raise ValueError(
            f"per-parameter Adam step counts differ ({sorted(set(steps))}) "
            "— checkpoint not from a plain full-parameter training run")
    return exp_avg, exp_avg_sq, (steps[0] if steps else 0)


def _adam_state(mu, nu, adam_count: int, schedule_count: int) -> AdamState:
    """The port's Adam state from imported moments (the counterpart of the
    JAX module's `_build_optax_state`): `count` is the torch step (both
    correct the next update's bias with count + 1), the schedule's step is
    epoch x the port's steps_per_epoch.  mu and nu, imported by the
    params' importer, list their leaves in the params' order."""
    return AdamState(count=adam_count, mu=tree_leaves(mu),
                     nu=tree_leaves(nu),
                     schedule_offset=schedule_count - adam_count)


def load_reference_training_state(path: str, model, steps_per_epoch: int,
                                  lr_decay: float | None = None):
    """Load a reference `.pth.tar` for a training resume: -> (params,
    AdamState | None, epoch).

    The reference restores `optimizer_state_dict` and
    `scheduler_state_dict` and continues from epoch + 1 (main.py:277-292).
    The torch Adam `exp_avg`/`exp_avg_sq` map onto mu/nu through the same
    per-tensor layout as the weights (transposes, zero-padded part heads:
    a pad takes no gradient, so its moments are 0), the torch `step`
    becomes Adam's count and the checkpoint's epoch the schedule's
    position.  A parameter with no optimizer entry (torch never stepped
    it) gets zero moments.  The AdamState is None when the checkpoint
    carries no optimizer state (weights only).  Unlike the JAX function
    it takes no optimizer: the port's Adam state holds nothing the
    optimizer sets."""
    ckpt = _load(path)
    auto_sd = _strip_prefix(ckpt.get("autoencoder_state_dict", ckpt))
    import_fn = _import_fn(model)
    params = import_fn(auto_sd, model)
    epoch = int(ckpt.get("epoch", 0))

    sched_sd = ckpt.get("scheduler_state_dict") or {}
    if lr_decay is not None and "gamma" in sched_sd:
        gamma = float(sched_sd["gamma"])
        if abs(gamma - lr_decay) > 1e-9:
            warnings.warn(
                f"checkpoint scheduler gamma {gamma} != configured "
                f"train.lr_decay {lr_decay}; resuming with the configured "
                "value", stacklevel=2)

    opt_sd = ckpt.get("optimizer_state_dict") or {}
    opt_state = None
    if opt_sd.get("state"):
        exp_avg, exp_avg_sq, step_count = _moment_dicts(opt_sd, auto_sd)
        for name, t in auto_sd.items():
            if name not in exp_avg:
                z = np.zeros_like(_np(t))
                exp_avg[name] = z
                exp_avg_sq[name] = z
        opt_state = _adam_state(import_fn(exp_avg, model),
                                import_fn(exp_avg_sq, model), step_count,
                                epoch * steps_per_epoch)
    return params, opt_state, epoch
