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
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

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
    count: int            # Adam steps taken (also the schedule's step)
    mu: list
    nu: list
    notfinite_count: int = 0


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
        if self.grad_clip > 0:
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        b1, b2 = self.B1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
            torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1.0 - b2 ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        step = torch._foreach_div(mu_hat, denom)
        updates = torch._foreach_mul(step, -self.schedule(state.count))
        return (tree_unflatten(tree, updates),
                replace(state, count=count, mu=mu, nu=nu))


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
