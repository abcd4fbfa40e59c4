"""Mesh pooling / unpooling as index gathers (counterpart of
`pool_take` / `unpool_take` in `semantichuman_tpu/ops/sampling.py`; the
one-hot and banded forms there are TPU dispatch and are not ported).

QEM downsampling is a pure row selection and barycentric upsampling has at
most 3 weighted sources per row, so both are gathers.
"""

from __future__ import annotations

import torch


def pool(x: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """x [B, V_f+1, C], pool_idx [V_c+1] int64 -> [B, V_c+1, C]."""
    return x.index_select(1, pool_idx)


def unpool(x: torch.Tensor, unpool_idx: torch.Tensor,
           unpool_w: torch.Tensor) -> torch.Tensor:
    """x [B, V_c+1, C], unpool_idx [V_f+1, 3] int64, unpool_w [V_f+1, 3]
    -> [B, V_f+1, C], the barycentric 3-gather and weighted sum."""
    b, _, c = x.shape
    vf1, k = unpool_idx.shape
    g = x.index_select(1, unpool_idx.reshape(-1)).reshape(b, vf1, k, c)
    return (g * unpool_w.to(x.dtype)[None, :, :, None]).sum(dim=2)
