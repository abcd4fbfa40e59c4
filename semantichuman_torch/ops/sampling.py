"""Mesh pooling / unpooling (counterpart of
`semantichuman_tpu/ops/sampling.py`).

QEM downsampling is a pure row selection and barycentric upsampling has at
most 3 weighted sources per row, so both are gathers.  `unpool` dispatches
as the JAX package's does, with the card in the TPU's place: a transition
whose tables carry a band (`models/tables.py`) takes the banded route
`unpool_banded` for a CUDA tensor at batch <= 128, every other call the
take route.  The JAX package's one-hot forms (TPU gather-engine
workarounds with the take route's values) are not ported, and neither is
its banded pool, which its own gate never routes to.
"""

from __future__ import annotations

import torch

from .banded_gather import BandedGatherFn, BandTable
from .row_gather import RowGatherFn

# the banded unpool's batch gate: the JAX dispatch's _UNPOOL_BAND_MAX_B,
# adopted with the card in the TPU's place
_UNPOOL_BAND_MAX_B = 128


def _unpool_band_ok(b: int, device: torch.device) -> bool:
    """The banded unpool runs on the card at batch <= 128; on the CPU the
    take route stays."""
    return device.type == "cuda" and b <= _UNPOOL_BAND_MAX_B


def pool(x: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """x [B, V_f+1, C], pool_idx [V_c+1] int64 -> [B, V_c+1, C]."""
    return x.index_select(1, pool_idx)


def unpool_take(x: torch.Tensor, unpool_idx: torch.Tensor,
                unpool_w: torch.Tensor) -> torch.Tensor:
    """The barycentric 3-gather and weighted sum."""
    b, _, c = x.shape
    vf1, k = unpool_idx.shape
    g = x.index_select(1, unpool_idx.reshape(-1)).reshape(b, vf1, k, c)
    return (g * unpool_w.to(x.dtype)[None, :, :, None]).sum(dim=2)


def unpool_banded(x: torch.Tensor, band: BandTable) -> torch.Tensor:
    """The banded route (counterpart of JAX `unpool_banded_pallas`): the
    <=3 taps of each fine row ride as flat [V_f*3] rows of the weighted
    banded gather, the out-of-band taps (weights read at their flat
    positions) are added through the row-gather kernel, and the taps are
    summed after the gather.  The weights are the table's, folded in when
    the band was built."""
    b, vc1, c = x.shape
    vf1 = band.n_rows // 3
    xp = x.transpose(0, 1).reshape(vc1, b * c).contiguous()
    g = BandedGatherFn.apply(xp, band)                  # [V_f*3, B*C]
    if band.fix is not None:
        g = g.index_add(0, band.fix_pos,
                        band.fix_w[:, None] * RowGatherFn.apply(xp, band.fix))
    y = g.reshape(vf1, 3, b, c).sum(dim=1)
    return y.permute(1, 0, 2).contiguous()


def unpool(x: torch.Tensor, unpool_idx: torch.Tensor,
           unpool_w: torch.Tensor, band: BandTable | None = None
           ) -> torch.Tensor:
    """x [B, V_c+1, C], unpool_idx [V_f+1, 3] int64, unpool_w [V_f+1, 3]
    -> [B, V_f+1, C]; `band` is the transition's band (built from the same
    unpool_idx and unpool_w), or None."""
    if band is not None and _unpool_band_ok(x.shape[0], x.device):
        return unpool_banded(x, band)
    return unpool_take(x, unpool_idx, unpool_w)
