"""The plain reference of the two autoencoders, in float32 PyTorch with no
kernel, cache or batching trick (the paper's PartAE, 'multiz+partkps', and
the neural3DMM baseline SpiralAE), written from the architecture:

    spiral conv   y[b, v] = act(concat_s x[b, spiral[v, s]] @ W + bias),
                  the dummy row (last) set to zero
    pool          y[b, v] = x[b, pool_idx[v]]
    unpool        y[b, v] = sum_t w[v, t] x[b, idx[v, t]]
    encoder       per level: convs, then pool
    decoder       per level: unpool, then convs; the last conv linear
    PartAE        17 per-part shape heads on the coarsest features, 17 pose
                  heads on the parts' keypoint groups, per-part decode
                  heads scattered back to coarse vertex order
    SpiralAE      flatten -> dense -> z -> dense -> coarse grid

It reads the topology from the hierarchy file both sides load, and the
parameters as a tree of the program's layout (`conv`, `dconv`, the heads),
which the benchmark makes and hands to both sides.  It imports nothing of
the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .constants import KPS_INDEX_LIST, KPS_KEEP


def elu(v):
    return torch.where(v > 0, v, torch.expm1(torch.clamp(v, max=0.0)))


@dataclass
class Topology:
    """The mesh hierarchy's tables on one device."""
    sizes: list            # V_l
    spirals: list          # [V_l + 1, S_l] int64, pads at the dummy row
    pool_idx: list         # [V_{l+1} + 1] int64
    unpool_idx: list       # [V_l + 1, 3] int64
    unpool_w: list         # [V_l + 1, 3] float32
    coarse_to_fine: np.ndarray

    @staticmethod
    def load(path: str, device) -> "Topology":
        with np.load(path, allow_pickle=False) as z:
            n = int(z["n_levels"])

            def t(a, dtype=torch.int64):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)

            return Topology(
                sizes=[len(z[f"verts_{l}"]) for l in range(n)],
                spirals=[t(z[f"spirals_{l}"]) for l in range(n)],
                pool_idx=[t(z[f"pool_idx_{l}"]) for l in range(n - 1)],
                unpool_idx=[t(z[f"unpool_idx_{l}"]) for l in range(n - 1)],
                unpool_w=[t(z[f"unpool_w_{l}"], torch.float32)
                          for l in range(n - 1)],
                coarse_to_fine=np.asarray(z["coarse_to_fine"]))

    @property
    def n_levels(self) -> int:
        return len(self.sizes)


def conv_plan(filters, n_levels: int, decoder: bool) -> list:
    """[(level, in_c, out_c, act)] of the conv stack, from the model's
    filter lists [main per level, extra per level]."""
    main, extra = filters
    plan = []
    in_c = main[0]
    if not decoder:
        for i in range(n_levels - 1):
            if extra[i]:
                plan.append((i, in_c, extra[i], "elu"))
                in_c = extra[i]
            plan.append((i, in_c, main[i + 1], "elu"))
            in_c = main[i + 1]
        return plan
    last = n_levels - 2
    for i in range(n_levels - 1):
        lvl = n_levels - 2 - i
        if i != last:
            plan.append((lvl, in_c, main[i + 1], "elu"))
            in_c = main[i + 1]
            if extra[i + 1]:
                plan.append((lvl, in_c, extra[i + 1], "elu"))
                in_c = extra[i + 1]
        elif extra[i + 1]:
            plan.append((lvl, in_c, main[i + 1], "elu"))
            plan.append((lvl, main[i + 1], extra[i + 1], "identity"))
        else:
            plan.append((lvl, in_c, main[i + 1], "identity"))
    return plan


def spiral_conv(x, spiral, w, b, act: str, dtype=torch.float32):
    """x [B, V1, C] -> [B, V1, Co]; `dtype` is the type the gather, the
    product and the sums are computed in."""
    bsz, v1, c = x.shape
    g = x.to(dtype)[:, spiral.reshape(-1)].reshape(bsz, v1, -1)
    y = (g @ w.to(dtype)).float() + b
    if act == "elu":
        y = elu(y)
    return torch.cat([y[:, :-1], y.new_zeros((bsz, 1, y.shape[2]))], dim=1)


def pool(x, idx):
    return x[:, idx]


def unpool(x, idx, w):
    return (x[:, idx] * w[None, :, :, None]).sum(dim=2)


def encoder(convs, plan, topo: Topology, x, dtype=torch.float32):
    j = 0
    for i in range(topo.n_levels - 1):
        while j < len(plan) and plan[j][0] == i:
            x = spiral_conv(x, topo.spirals[i], convs[j]["w"], convs[j]["b"],
                            plan[j][3], dtype)
            j += 1
        x = pool(x, topo.pool_idx[i])
    return x


def decoder(convs, plan, topo: Topology, x, dtype=torch.float32):
    j = 0
    for i in range(topo.n_levels - 1):
        lvl = topo.n_levels - 2 - i
        x = unpool(x, topo.unpool_idx[lvl], topo.unpool_w[lvl])
        while j < len(plan) and plan[j][0] == lvl:
            x = spiral_conv(x, topo.spirals[lvl], convs[j]["w"],
                            convs[j]["b"], plan[j][3], dtype)
            j += 1
    return x


class PartAE:
    """The part-aware autoencoder over `topo`, with the fine-level part
    partition `part_dict` (17 parts), mapped onto the coarsest level."""

    def __init__(self, topo: Topology, part_dict: dict, filters_enc,
                 filters_dec, dtype=torch.float32):
        self.topo, self.dtype = topo, dtype
        n = topo.n_levels
        self.enc_plan = conv_plan(filters_enc, n, False)
        self.dec_plan = conv_plan(filters_dec, n, True)
        self.enc_c = self.enc_plan[-1][2]
        self.dec_c = filters_dec[0][0]
        dev = topo.spirals[0].device
        coarse = [np.nonzero(np.isin(topo.coarse_to_fine, np.asarray(f)))[0]
                  for f in part_dict.values()]
        self.n_parts = len(coarse)
        self.coarse_v = cv = topo.sizes[-1]
        self.n_max = max(len(p) for p in coarse)
        pad = np.full((self.n_parts, self.n_max), cv, np.int64)
        for p, idx in enumerate(coarse):
            pad[p, :len(idx)] = idx
        self.pad_idx = torch.as_tensor(pad.reshape(-1), device=dev)
        g_max = max(len(g) for g in KPS_INDEX_LIST)
        kidx = np.zeros((self.n_parts, g_max), np.int64)
        kmask = np.zeros((self.n_parts, g_max), np.float32)
        for p, g in enumerate(KPS_INDEX_LIST):
            kidx[p, :len(g)] = g
            kmask[p, :len(g)] = 1.0
        self.g_max = g_max
        self.kidx = torch.as_tensor(kidx.reshape(-1), device=dev)
        self.kmask = torch.as_tensor(kmask.reshape(-1), device=dev)

    def kps_encode(self, params, kps):
        b = kps.shape[0]
        g = (kps[:, self.kidx] * self.kmask[None, :, None]).reshape(
            b, self.n_parts, self.g_max * 3)
        h = params["kps_heads"]
        return torch.einsum("bpk,pkl->bpl", g, h["w"]) + h["b"][None]

    def encode(self, params, x, kps):
        """x [B, V+1, 3], kps [B, 32, 3] -> (z, z_kps, dummy [B, 1, C])."""
        hid = encoder(params["conv"], self.enc_plan, self.topo, x, self.dtype)
        b = hid.shape[0]
        g = hid[:, self.pad_idx].reshape(b, self.n_parts,
                                         self.n_max * self.enc_c)
        h = params["enc_heads"]
        z = torch.einsum("bpk,pkl->bpl", g, h["w"]) + h["b"][None]
        return z, self.kps_encode(params, kps), hid[:, -1:]

    def decode(self, params, z, z_kps, dummy):
        """-> [B, V+1, 3]; padded head outputs land on the coarse dummy
        row, which the encoder's dummy then replaces."""
        b = z.shape[0]
        h = params["dec_heads"]
        y = torch.einsum("bpl,plk->bpk", torch.cat([z, z_kps], dim=-1),
                         h["w"]) + h["b"][None]
        y = y.reshape(b, self.n_parts * self.n_max, self.dec_c)
        out = y.new_zeros((b, self.coarse_v + 1, self.dec_c))
        out = out.index_put((torch.arange(b, device=y.device)[:, None],
                             self.pad_idx[None, :]), y)
        out = torch.cat([out[:, :self.coarse_v], dummy], dim=1)
        return decoder(params["dconv"], self.dec_plan, self.topo, out,
                       self.dtype)

    def forward(self, params, x, kps):
        z, zk, dummy = self.encode(params, x, kps)
        return self.decode(params, z, zk, dummy), z, zk


class SpiralAE:
    """The neural3DMM baseline: the trunk, then one dense layer each way
    (nz latents; the VAE's mean only)."""

    def __init__(self, topo: Topology, filters_enc, filters_dec, nz: int,
                 dtype=torch.float32):
        self.topo, self.nz, self.dtype = topo, nz, dtype
        n = topo.n_levels
        self.enc_plan = conv_plan(filters_enc, n, False)
        self.dec_plan = conv_plan(filters_dec, n, True)
        self.dec_c = filters_dec[0][0]
        self.rows = topo.sizes[-1] + 1

    def forward(self, params, x):
        h = encoder(params["conv"], self.enc_plan, self.topo, x, self.dtype)
        z = h.reshape(h.shape[0], -1) @ params["fc_enc"]["w"] \
            + params["fc_enc"]["b"]
        z = z[:, :self.nz]
        h = z @ params["fc_dec"]["w"] + params["fc_dec"]["b"]
        h = h.reshape(z.shape[0], self.rows, self.dec_c)
        return decoder(params["dconv"], self.dec_plan, self.topo, h,
                       self.dtype), z


def regress(j_regressor, verts_nodummy):
    """[B, V, 3] -> [B, 35, 3] keypoints."""
    return torch.einsum("jv,bvd->bjd", j_regressor, verts_nodummy)


def keep_kps(kps_full):
    return kps_full[:, torch.as_tensor(KPS_KEEP, device=kps_full.device)]
