"""SpiralAE — the neural3DMM baseline autoencoder (model_type='neural3DMM';
reference models.py:55-162; counterpart of
`semantichuman_tpu/models/spiral_ae.py`).

Encoder: spiral convs + pool per level, flatten, one dense layer -> z.
Decoder: dense -> coarse grid, unpool + spiral convs per level (identity
activation on the final conv).  The trunk is the port's
(`models/common.py`): the convs go through the spiral conv kernels, pool
and unpool through the row gather.  The two dense layers are plain
matrix products.  With `vae`, encode returns the mean unless it is given
a torch.Generator to sample with.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.spiral_conv import spiral_conv
from ..utils.params import params_from_jax
from ..utils.seeding import as_seed
from .common import (decoder_trunk, encoder_trunk, init_conv_stack,
                     linear_init, plan_conv_stack)
from .tables import DeviceTables


class SpiralAE(nn.Module):
    def __init__(self, tables: DeviceTables, filters_enc, filters_dec,
                 latent_size: int, vae: bool = False, compute_dtype=None,
                 conv_fn=spiral_conv):
        super().__init__()
        self.tables = tables
        self.latent_size = latent_size
        self.vae = vae
        self.compute_dtype = compute_dtype
        self.conv_fn = conv_fn
        n_levels = tables.n_levels
        self.enc_plan, self.enc_out_c = plan_conv_stack(
            filters_enc[0], filters_enc[1], tables.spiral_sizes, n_levels,
            decoder=False)
        self.dec_plan, _ = plan_conv_stack(
            filters_dec[0], filters_dec[1], tables.spiral_sizes, n_levels,
            decoder=True)
        self.dec_in_c = filters_dec[0][0]
        self.coarse_rows = tables.sizes[-1] + 1

    def init(self, seed: int = 0) -> dict:
        """Parameters from a host NumPy generator: the JAX package's
        SpiralAE.init(seed) arrays, as tensors on the model's device."""
        rng = np.random.default_rng(as_seed(seed))
        enc_flat = self.coarse_rows * self.enc_out_c
        z_out = 2 * self.latent_size if self.vae else self.latent_size
        w_enc, b_enc = linear_init(rng, enc_flat, (enc_flat, z_out), (z_out,))
        dec_flat = self.coarse_rows * self.dec_in_c
        w_dec, b_dec = linear_init(rng, self.latent_size,
                                   (self.latent_size, dec_flat), (dec_flat,))
        params = {
            "conv": init_conv_stack(rng, self.enc_plan,
                                    self.tables.spiral_sizes),
            "dconv": init_conv_stack(rng, self.dec_plan,
                                     self.tables.spiral_sizes),
            "fc_enc": {"w": w_enc, "b": b_enc},
            "fc_dec": {"w": w_dec, "b": b_dec},
        }
        return params_from_jax(params, self.tables.device)

    def encode(self, params, x, generator: torch.Generator | None = None):
        """x [B, V+1, 3] -> z [B, nz]; with `vae`, the mean, or mu + eps *
        std with eps drawn from `generator` when one is given."""
        h = encoder_trunk(params["conv"], self.enc_plan, self.tables, x,
                          self.compute_dtype, self.conv_fn)
        h = h.reshape(h.shape[0], -1)
        z = h @ params["fc_enc"]["w"] + params["fc_enc"]["b"]
        if not self.vae:
            return z
        mu, logvar = z[..., :self.latent_size], z[..., self.latent_size:]
        if generator is None:
            return mu
        std = torch.exp(logvar / 2.0)
        eps = torch.randn(std.shape, generator=generator, device=std.device,
                          dtype=std.dtype)
        return mu + eps * std

    def decode(self, params, z):
        """z [B, nz] -> [B, V+1, 3]."""
        h = z @ params["fc_dec"]["w"] + params["fc_dec"]["b"]
        h = h.reshape(z.shape[0], self.coarse_rows, self.dec_in_c)
        return decoder_trunk(params["dconv"], self.dec_plan, self.tables, h,
                             self.compute_dtype, self.conv_fn)

    def forward(self, params, x, generator: torch.Generator | None = None):
        z = self.encode(params, x, generator)
        return self.decode(params, z), z
