"""PartAE — the paper's part-aware, skeleton-separated autoencoder
(model_type='multiz+partkps'; counterpart of
`semantichuman_tpu/models/part_ae.py`).

The spiral-conv trunk feeds a per-part bottleneck:
  * 17 shape heads: coarse-level features of each part's vertices -> z;
  * 17 pose heads: each part's keypoint group coords -> z_kps;
  * decode: per-part Linear(nz+nk -> n_part·C) -> scatter back into mesh
    vertex order -> append dummy -> unpool+conv trunk.

Parts are padded to a common vertex count and all heads run as one batched
einsum [P, n_max·C, nz].  Padded positions gather the always-zero coarse
dummy row, so the padded weight rows multiply zeros and the math is the
ragged math.  Parameters are an explicit nested dict with the JAX package's
names and shapes, so one model object serves any parameter set.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..constants import KPS_KEEP
from ..ops.row_gather import GatherTable, gather_rows
from ..ops.spiral_conv import spiral_conv
from ..utils.params import params_from_jax
from .common import (decoder_trunk, encoder_trunk, init_conv_stack,
                     linear_init, plan_conv_stack)
from .tables import DeviceTables


class PartAE(nn.Module):
    def __init__(self, tables: DeviceTables, part_indices: dict,
                 kps_index_list, filters_enc, filters_dec,
                 latent_size: int = 8, part_kps_latent_size: int = 8,
                 compute_dtype=None, conv_fn=spiral_conv):
        super().__init__()
        self.tables = tables
        self.latent_size = latent_size
        self.kps_latent_size = part_kps_latent_size
        self.compute_dtype = compute_dtype
        self.conv_fn = conv_fn
        self.filters_enc, self.filters_dec = filters_enc, filters_dec
        n_levels = tables.n_levels
        self.enc_plan, self.enc_out_c = plan_conv_stack(
            filters_enc[0], filters_enc[1], tables.spiral_sizes, n_levels,
            decoder=False)
        self.dec_plan, _ = plan_conv_stack(
            filters_dec[0], filters_dec[1], tables.spiral_sizes, n_levels,
            decoder=True)
        self.dec_in_c = filters_dec[0][0]
        dev = tables.device

        # --- padded part layout at the coarsest level -----------------------
        self.part_indices = {k: np.asarray(v, dtype=np.int64)
                             for k, v in part_indices.items()}
        plist = list(self.part_indices.values())
        self.part_sizes = [len(p) for p in plist]
        self.n_parts = len(plist)
        self.coarse_v = coarse_v = tables.sizes[-1]
        self.n_max = n_max = max(self.part_sizes)
        pad_idx = np.full((self.n_parts, n_max), coarse_v, dtype=np.int64)
        for p, idx in enumerate(plist):
            pad_idx[p, :len(idx)] = idx
        real = pad_idx[pad_idx != coarse_v]
        if len(np.unique(real)) != len(real) or np.any(real < 0) \
                or np.any(real > coarse_v):
            # the decode scatter relies on unique real targets; only the
            # padded slots share (and overwrite) the trash row V
            raise ValueError("part indices must be unique coarse vertices")
        # encode gathers through part_gather and decode scatters through
        # this index; padded slots address the dummy / trash row V
        self.register_buffer("part_pad_idx",
                             torch.as_tensor(pad_idx.reshape(-1), device=dev),
                             persistent=False)
        self.part_gather = GatherTable.build(pad_idx.reshape(-1),
                                             coarse_v + 1, dev)

        # --- padded keypoint-group layout -----------------------------------
        self.kps_index_list = [list(g) for g in kps_index_list]
        self.g_max = g_max = max(len(g) for g in self.kps_index_list)
        kidx = np.zeros((self.n_parts, g_max), dtype=np.int64)
        kmask = np.zeros((self.n_parts, g_max), dtype=np.float32)
        for p, g in enumerate(self.kps_index_list):
            kidx[p, :len(g)] = g
            kmask[p, :len(g)] = 1.0
        # padded slots gather keypoint 0 with weight 0
        self.kps_gather = GatherTable.build(kidx.reshape(-1), len(KPS_KEEP),
                                            dev, w=kmask.reshape(-1))

    # --- params ---------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Parameters from a host NumPy generator: the same arrays as the
        JAX package's PartAE.init(seed), as tensors on the model's device."""
        rng = np.random.default_rng(int(seed))
        c = self.enc_out_c
        nz, nk = self.latent_size, self.kps_latent_size
        # per-part heads, padded: init bound from each part's TRUE fan-in
        w_enc = np.zeros((self.n_parts, self.n_max * c, nz), np.float32)
        b_enc = np.zeros((self.n_parts, nz), np.float32)
        w_dec = np.zeros((self.n_parts, nz + nk, self.n_max * self.dec_in_c),
                         np.float32)
        b_dec = np.zeros((self.n_parts, self.n_max * self.dec_in_c), np.float32)
        w_kps = np.zeros((self.n_parts, self.g_max * 3, nk), np.float32)
        b_kps = np.zeros((self.n_parts, nk), np.float32)
        for p in range(self.n_parts):
            n_p = self.part_sizes[p]
            g_p = len(self.kps_index_list[p])
            we, be = linear_init(rng, n_p * c, (n_p * c, nz), (nz,))
            w_enc[p, :n_p * c] = we
            b_enc[p] = be
            wd, bd = linear_init(rng, nz + nk,
                                 (nz + nk, n_p * self.dec_in_c),
                                 (n_p * self.dec_in_c,))
            w_dec[p, :, :n_p * self.dec_in_c] = wd
            b_dec[p, :n_p * self.dec_in_c] = bd
            wk, bk = linear_init(rng, g_p * 3, (g_p * 3, nk), (nk,))
            w_kps[p, :g_p * 3] = wk
            b_kps[p] = bk
        params = {
            "conv": init_conv_stack(rng, self.enc_plan,
                                    self.tables.spiral_sizes),
            "dconv": init_conv_stack(rng, self.dec_plan,
                                     self.tables.spiral_sizes),
            "enc_heads": {"w": w_enc, "b": b_enc},
            "dec_heads": {"w": w_dec, "b": b_dec},
            "kps_heads": {"w": w_kps, "b": b_kps},
        }
        return params_from_jax(params, self.tables.device)

    # --- apply ---------------------------------------------------------------
    def kps_encode(self, params, kps):
        """kps [B, 32, 3] kept keypoints -> z_kps [B, P, nk]."""
        b = kps.shape[0]
        g = gather_rows(kps, self.kps_gather)
        g = g.reshape(b, self.n_parts, self.g_max * 3)
        hp = params["kps_heads"]
        return torch.einsum("bpk,pkl->bpl", g, hp["w"]) + hp["b"][None]

    def encode(self, params, x, kps):
        """x [B, V+1, 3], kps [B, 32, 3] ->
        (z [B, P, nz], z_kps [B, P, nk], dummy [B, 1, C])."""
        h = encoder_trunk(params["conv"], self.enc_plan, self.tables, x,
                          self.compute_dtype, self.conv_fn)
        b = h.shape[0]
        # padded per-part feature blocks; pads hit the zeroed dummy row
        g = gather_rows(h, self.part_gather)
        g = g.reshape(b, self.n_parts, self.n_max * self.enc_out_c)
        hp = params["enc_heads"]
        z = torch.einsum("bpk,pkl->bpl", g, hp["w"]) + hp["b"][None]
        z_kps = self.kps_encode(params, kps)
        return z, z_kps, h[:, -1:, :]

    def decode(self, params, z, z_kps, dummy):
        """z [B, P, nz], z_kps [B, P, nk], dummy [B, 1, C] -> [B, V+1, 3]."""
        b = z.shape[0]
        zz = torch.cat([z, z_kps], dim=-1)                   # [B, P, nz+nk]
        hp = params["dec_heads"]
        y = torch.einsum("bpl,plk->bpk", zz, hp["w"]) + hp["b"][None]
        y = y.reshape(b, self.n_parts * self.n_max, self.dec_in_c)
        # scatter part blocks back to coarse mesh vertex order; padded slots
        # all land on the trash row V (which of them lands is unspecified on
        # CUDA), and that row is replaced by the encoder dummy below
        out = y.new_zeros((b, self.coarse_v + 1, self.dec_in_c))
        out[:, self.part_pad_idx] = y
        out = torch.cat([out[:, :self.coarse_v], dummy], dim=1)
        return decoder_trunk(params["dconv"], self.dec_plan, self.tables, out,
                             self.compute_dtype, self.conv_fn)

    def forward(self, params, x, kps):
        z, z_kps, dummy = self.encode(params, x, kps)
        return self.decode(params, z, z_kps, dummy), z, z_kps

    @staticmethod
    def kps2skl(kps, mode: str = "ori_m"):
        """kps [B, 32|35, 3] -> the skeleton in `mode`
        (`ops.skeleton.kps2skl`)."""
        from ..ops.skeleton import kps2skl
        return kps2skl(kps, mode)
