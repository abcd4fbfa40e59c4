"""Shared model plumbing: parameter init and the spiral conv trunk
(counterpart of `semantichuman_tpu/models/common.py`)."""

from __future__ import annotations

import numpy as np

from ..ops.sampling import pool, unpool
from ..ops.spiral_conv import spiral_conv


def linear_init(rng: np.random.Generator, fan_in: int, shape_w, shape_b=None,
                dtype=np.float32):
    """torch.nn.Linear default init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from a host NumPy generator so that a seed gives the JAX package's
    exact arrays."""
    bound = 1.0 / np.sqrt(max(fan_in, 1))
    w = rng.uniform(-bound, bound, size=shape_w).astype(dtype)
    if shape_b is None:
        return w
    b = rng.uniform(-bound, bound, size=shape_b).astype(dtype)
    return w, b


def plan_conv_stack(filters_main, filters_extra, spiral_sizes, n_levels,
                    decoder: bool):
    """Flatten the per-level conv stacking rules into an explicit layer
    plan: list of (level, in_c, out_c, activation).

    Encoder per level i: optional extra conv (in -> filters_extra[i]) then
    main conv (in -> filters_main[i+1]), both on spiral table i, followed by
    pooling.  Decoder per step i: unpool first, conv(s) on spiral table
    (n_levels-2-i); the final conv of the whole decoder uses identity
    activation.
    """
    plan = []
    if not decoder:
        in_c = filters_main[0]
        for i in range(n_levels - 1):
            if filters_extra[i]:
                plan.append((i, in_c, filters_extra[i], "elu"))
                in_c = filters_extra[i]
            plan.append((i, in_c, filters_main[i + 1], "elu"))
            in_c = filters_main[i + 1]
        return plan, in_c
    in_c = filters_main[0]
    last = n_levels - 2
    for i in range(n_levels - 1):
        lvl = n_levels - 2 - i
        if i != last:
            plan.append((lvl, in_c, filters_main[i + 1], "elu"))
            in_c = filters_main[i + 1]
            if filters_extra[i + 1]:
                plan.append((lvl, in_c, filters_extra[i + 1], "elu"))
                in_c = filters_extra[i + 1]
        else:
            if filters_extra[i + 1]:
                plan.append((lvl, in_c, filters_main[i + 1], "elu"))
                plan.append((lvl, filters_main[i + 1], filters_extra[i + 1],
                             "identity"))
                in_c = filters_extra[i + 1]
            else:
                plan.append((lvl, in_c, filters_main[i + 1], "identity"))
                in_c = filters_main[i + 1]
    return plan, in_c


def init_conv_stack(rng: np.random.Generator, plan, spiral_sizes):
    """Per-layer {"w": [S*in_c, out_c], "b": [out_c]} numpy params."""
    params = []
    for (lvl, in_c, out_c, _act) in plan:
        fan_in = spiral_sizes[lvl] * in_c
        w, b = linear_init(rng, fan_in, (fan_in, out_c), (out_c,))
        params.append({"w": w, "b": b})
    return params


def _band_kw(tables, level: int) -> dict:
    """`band=` only for levels that carry one, so a conv_fn without the
    keyword (a test's) keeps working on unbanded tables."""
    band = tables.band_for(level)
    return {"band": band} if band is not None else {}


def encoder_trunk(params_conv, plan, tables, x, compute_dtype=None,
                  conv_fn=spiral_conv):
    """Apply encoder convs + pooling; returns coarse features [B, V_L+1, C]."""
    j = 0
    for i in range(tables.n_levels - 1):
        while j < len(plan) and plan[j][0] == i:
            p = params_conv[j]
            x = conv_fn(x, tables.spirals[i], p["w"], p["b"], plan[j][3],
                        compute_dtype=compute_dtype,
                        csr=tables.spiral_csr[i], **_band_kw(tables, i))
            j += 1
        x = pool(x, tables.pool_gather[i])
    return x


def decoder_trunk(params_conv, plan, tables, x, compute_dtype=None,
                  conv_fn=spiral_conv):
    """Apply unpooling + decoder convs; x starts at the coarsest level."""
    j = 0
    for i in range(tables.n_levels - 1):
        lvl = tables.n_levels - 2 - i
        x = unpool(x, tables.unpool_gather[lvl],
                   band=tables.unpool_band_for(lvl))
        while j < len(plan) and plan[j][0] == lvl:
            p = params_conv[j]
            x = conv_fn(x, tables.spirals[lvl], p["w"], p["b"], plan[j][3],
                        compute_dtype=compute_dtype,
                        csr=tables.spiral_csr[lvl], **_band_kw(tables, lvl))
            j += 1
    return x
