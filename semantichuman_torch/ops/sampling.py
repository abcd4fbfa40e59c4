"""Mesh pooling / unpooling (counterpart of
`semantichuman_tpu/ops/sampling.py`).

QEM downsampling is a pure row selection and barycentric upsampling has at
most 3 weighted sources per row, so both are gathers: `pool` the T = 1 and
`unpool_take` the weighted T = 3 case of `ops/row_gather.py:gather_rows`,
whose backward is the fixed-order CSR reduce (no `[B, V_f, 3, C]` buffer in
either direction, no atomics).  `unpool` dispatches
as the JAX package's does, with the card in the TPU's place: a transition
whose tables carry a band (`models/tables.py`) takes the banded route
`unpool_banded` for a CUDA tensor at a batch its gate lets through (none,
since the card's measurements closed it), every other call the take
route.  The JAX package's one-hot forms (TPU gather-engine
workarounds with the take route's values) are not ported, and neither is
its banded pool, which its own gate never routes to.
"""

from __future__ import annotations

import torch

from .banded_gather import BandedGatherFn, BandTable
from .row_gather import GatherTable, RowGatherFn, gather_rows

# the banded unpool's batch gate, set from the card's measurements as the
# conv's (`ops/spiral_conv.py:_BANDED_MAX_B`): the banded unpool won at no
# batch measured (1, 16, 64 serving; trunk 12 and 128 training), so it is
# closed.  The JAX dispatch's gate, 128, was set on the TPU.
_UNPOOL_BAND_MAX_B = 0


def _unpool_band_ok(b: int, device: torch.device) -> bool:
    """The banded unpool runs on the card at batch <= _UNPOOL_BAND_MAX_B
    (at no batch: the gate is closed); on the CPU the take route stays."""
    return device.type == "cuda" and b <= _UNPOOL_BAND_MAX_B


def pool(x: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """x [B, V_f+1, C] -> [B, V_c+1, C]; `table` is the transition's pool
    gather (`DeviceTables.pool_gather`, from pool_idx [V_c+1])."""
    return gather_rows(x, table)


def unpool_take(x: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """The barycentric 3-tap weighted gather, the taps summed in f32 in
    order; `table` is the transition's unpool gather
    (`DeviceTables.unpool_gather`, from unpool_idx and unpool_w)."""
    return gather_rows(x, table)


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
        # the banded gather wrote 0 at every out-of-band row, so the fix-up
        # puts (no atomics) where the JAX form adds
        g = g.index_put((band.fix_pos,),
                        band.fix_w[:, None] * RowGatherFn.apply(xp, band.fix))
    y = g.reshape(vf1, 3, b, c).sum(dim=1)
    return y.permute(1, 0, 2).contiguous()


def unpool(x: torch.Tensor, table: GatherTable,
           band: BandTable | None = None) -> torch.Tensor:
    """x [B, V_c+1, C] -> [B, V_f+1, C]; `table` is the transition's unpool
    gather and `band` its band (both built from the same unpool_idx and
    unpool_w), or None."""
    if band is not None and _unpool_band_ok(x.shape[0], x.device):
        return unpool_banded(x, band)
    return unpool_take(x, table)
