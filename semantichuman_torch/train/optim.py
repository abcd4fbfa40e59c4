"""Optimizer and lr schedule of the training step (counterpart of
`semantichuman_tpu/train/optim.py`, an optax chain), written out as one
functional Adam:

    [clip_by_global_norm] -> add_decayed_weights -> scale_by_adam
    -> scale_by_learning_rate(schedule), all under [apply_if_finite]

The decay is added to the gradient before the moments (coupled L2, as
torch.optim.Adam(weight_decay=λ) does; not AdamW), after the global-norm
clip.  The clip is optax's: no epsilon is added to the norm.  `init`
returns the state and `update` returns (updates, new state) for lists of
trees (dicts and lists) of tensors, without changing its arguments.

`update_` is the same update in place, for a step captured as a CUDA graph
(`train/graph.py`): a capture records the host's numbers as constants, so
the step's lr and bias corrections come in as device tensors, and
`skip_nonfinite` becomes optax.apply_if_finite's rule on the device.  Both
take those three numbers from `step_scalars` (the schedule and the bias
corrections in double, rounded once to float32) as a float32 tensor, so
the two give the same bits.

The state keeps optax's two counters: `count` (Adam's, which drives the
bias corrections) and the lr schedule's step, `count + schedule_offset`.
They advance together, so the offset is 0 unless a reference checkpoint
set them apart (`utils/import_torch.py`: Adam's count is the torch
`step`, the schedule's is epoch x steps_per_epoch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.params import tree_leaves, tree_unflatten


def make_schedule(lr: float, lr_decay: float, steps_per_epoch: int,
                  warmup_epochs: int = 0, schedule_kind: str = "exp",
                  n_epochs: int = 0):
    """step -> lr: the reference's per-epoch exponential decay ('exp') or a
    cosine anneal to 0 over n_epochs ('cosine'), each optionally under a
    linear warm-up over the first warmup_epochs."""
    spe = max(steps_per_epoch, 1)
    if schedule_kind not in ("exp", "cosine"):
        raise ValueError(f"unknown schedule_kind {schedule_kind!r}")
    if schedule_kind == "cosine" and n_epochs <= 0:
        raise ValueError("schedule_kind='cosine' needs n_epochs")

    def schedule(step: int) -> float:
        epoch = step // spe
        if schedule_kind == "cosine":
            frac = min(max(epoch / max(n_epochs, 1), 0.0), 1.0)
            out = lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        else:
            out = lr * (lr_decay ** epoch)
        if warmup_epochs:
            out = out * min((step + 1.0) / (warmup_epochs * spe), 1.0)
        return out

    return schedule


@dataclass(frozen=True)
class AdamState:
    count: int            # Adam steps taken (the bias corrections' t - 1)
    mu: list
    nu: list
    notfinite_count: int = 0
    # the lr schedule's step minus count (a state saved without it: 0)
    schedule_offset: int = 0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Adam:
    """The optax chain of `semantichuman_tpu.train.optim.make_optimizer`."""

    B1 = 0.9
    EPS = 1e-8

    def __init__(self, schedule, weight_decay: float, b2: float = 0.999,
                 grad_clip: float = 0.0, skip_nonfinite: int = 0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b2 = b2
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite

    def init(self, params) -> AdamState:
        leaves = tree_leaves(params)
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in leaves],
                         nu=[torch.zeros_like(p) for p in leaves])

    def update(self, grads, state: AdamState, params):
        """-> (updates, new state), updates a tree like grads; params +
        updates is the next step."""
        tree = grads
        grads = [g.detach() for g in tree_leaves(grads)]
        params = [p.detach() for p in tree_leaves(params)]
        if self.skip_nonfinite > 0:
            # one host sync per step, only in this mode
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all())
            bad = 0 if finite else state.notfinite_count + 1
            if not finite and bad <= self.skip_nonfinite:
                return (tree_unflatten(tree, [torch.zeros_like(g)
                                              for g in grads]),
                        replace(state, notfinite_count=bad))
            state = replace(state, notfinite_count=bad)
        scalars = torch.from_numpy(self.step_scalars(
            state.count, 1, state.schedule_offset)[0])
        mu, nu, updates = self._moments(grads, params, state.mu, state.nu,
                                        scalars.to(grads[0].device))
        return (tree_unflatten(tree, updates),
                replace(state, count=state.count + 1, mu=mu, nu=nu))

    def step_scalars(self, count: int, k: int,
                     schedule_offset: int = 0) -> np.ndarray:
        """[k, 3] float32: (-lr, 1 - b1^t, 1 - b2^t) of the k Adam steps
        that start at state.count = count (the lr at schedule step count +
        schedule_offset), computed in double precision and rounded once
        to float32."""
        out = np.empty((k, 3), np.float32)
        for j in range(k):
            c = count + j
            out[j] = (-self.schedule(c + schedule_offset),
                      1.0 - self.B1 ** (c + 1), 1.0 - self.b2 ** (c + 1))
        return out

    def update_(self, grads, params, mu, nu, scalars, bad=None):
        """`update` in place, with no host read: params, mu and nu (lists of
        tensors) take their new values; scalars [3] float32 on their device
        is this step's row of `step_scalars`.  With skip_nonfinite > 0, bad
        (a 0-d int64 tensor, the count of non-finite steps in a row) is
        updated in place, a step is applied as optax.apply_if_finite
        decides, and the returned 0-d bool tensor says whether it was
        (state.count advances only then); else None is returned."""
        grads = [g.detach() for g in grads]
        keep = None
        if self.skip_nonfinite > 0:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            bad.copy_(torch.where(finite, torch.zeros_like(bad), bad + 1))
            keep = finite | (bad > self.skip_nonfinite)
        new_mu, new_nu, updates = self._moments(grads, params, mu, nu,
                                                scalars)
        if keep is not None:
            new_mu = [torch.where(keep, a, b) for a, b in zip(new_mu, mu)]
            new_nu = [torch.where(keep, a, b) for a, b in zip(new_nu, nu)]
            updates = [torch.where(keep, u, torch.zeros_like(u))
                       for u in updates]
        torch._foreach_copy_(mu, new_mu)
        torch._foreach_copy_(nu, new_nu)
        torch._foreach_add_(params, updates)
        return keep

    def _moments(self, grads, params, mu, nu, scalars):
        """(new mu, new nu, updates) of one step from the raw gradients;
        scalars [3] float32 on the gradients' device: -lr, 1 - b1^t,
        1 - b2^t.  Both `update` and `update_` take them as a tensor, so
        the loop and a captured step divide and multiply alike (on the
        card `_foreach_div` by a Python float rounds otherwise than a
        division by the same float32 number)."""
        if self.grad_clip > 0:
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        b1, b2 = self.B1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
            torch._foreach_mul(nu, b2))
        neg_lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
        mu_hat = [m / bc1 for m in mu]
        nu_hat = [n / bc2 for n in nu]
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        step = torch._foreach_div(mu_hat, denom)
        return list(mu), list(nu), [s * neg_lr for s in step]


def make_optimizer(lr: float, weight_decay: float, lr_decay: float,
                   steps_per_epoch: int, warmup_epochs: int = 0,
                   schedule_kind: str = "exp", n_epochs: int = 0,
                   grad_clip: float = 0.0, adam_b2: float = 0.999,
                   skip_nonfinite: int = 0) -> Adam:
    """torch.optim.Adam(lr, weight_decay) semantics (coupled L2) on the
    schedule of make_schedule; grad_clip > 0 clips the global norm of the
    raw gradients, adam_b2 sets the second-moment decay, skip_nonfinite > 0
    skips (zero update, state kept) steps whose gradients hold NaN or Inf,
    up to that many in a row."""
    schedule = make_schedule(lr, lr_decay, steps_per_epoch, warmup_epochs,
                             schedule_kind, n_epochs)
    return Adam(schedule, weight_decay, b2=adam_b2, grad_clip=grad_clip,
                skip_nonfinite=skip_nonfinite)
