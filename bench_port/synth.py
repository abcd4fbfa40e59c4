"""The benchmark's inputs, made from `--seed` by the benchmark itself and
handed alike to the program and to the plain reference.

  * `Human`: a synthetic SMPL-shaped asset bundle (a closed 6892-vertex
    template, 17 parts, a 35-keypoint regressor, 16 girth rings), the
    same arrays as the template that `assets/topology_synth_full_2222.npz`
    was compiled from, and its deformed samples and their 32 measures,
    computed in bulk on the device.
  * `make_params`: model weights for a parameter tree of the program's
    layout, drawn on the device from one generator in one call, each leaf
    uniform in +-1/sqrt(fan_in) as torch.nn.Linear draws them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.constants import (MEASURE_SKL_LIST, N_KPS_FULL, N_PARTS,
                                  NEWSKL_LIST, PART_LIST,
                                  bone_endpoint_arrays)


def _human_radius(y01, theta):
    """A lumpy, asymmetric body-like profile (head, shoulders, hips)."""
    base = (0.16
            + 0.10 * np.exp(-((y01 - 0.92) / 0.05) ** 2)
            + 0.16 * np.exp(-((y01 - 0.70) / 0.12) ** 2)
            + 0.14 * np.exp(-((y01 - 0.45) / 0.10) ** 2)
            + 0.05 * np.exp(-((y01 - 0.15) / 0.08) ** 2))
    lobes = 1.0 + 0.25 * np.cos(2 * theta) * np.exp(-((y01 - 0.3) / 0.25) ** 2)
    return base * lobes


def _capsule(n_theta: int, n_phi: int):
    """A closed surface of revolution around +y with two poles:
    (verts [n_theta * n_phi + 2, 3] float64, faces int32)."""
    thetas = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    ys = np.linspace(0.0, 1.0, n_phi + 2)[1:-1]
    grid_t, grid_y = np.meshgrid(thetas, ys, indexing="ij")
    r = _human_radius(grid_y, grid_t)
    r = r * np.sqrt(np.clip(np.sin(np.pi * grid_y), 1e-3, None))
    ring = np.stack([r * np.cos(grid_t), grid_y * 1.8 - 0.9,
                     r * np.sin(grid_t)], axis=-1).reshape(-1, 3)
    verts = np.concatenate([ring, [[0.0, -0.9, 0.0]], [[0.0, 0.9, 0.0]]])
    vid = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    s_id, n_id = n_theta * n_phi, n_theta * n_phi + 1
    faces = []
    for t in range(n_theta):
        t2 = (t + 1) % n_theta
        for p in range(n_phi - 1):
            a, b = vid[t, p], vid[t2, p]
            c, d = vid[t, p + 1], vid[t2, p + 1]
            faces += [[a, b, c], [b, d, c]]
        faces.append([vid[t2, 0], vid[t, 0], s_id])
        faces.append([vid[t, n_phi - 1], vid[t2, n_phi - 1], n_id])
    return verts, np.asarray(faces, dtype=np.int32)


class Human:
    """template_verts [V, 3], template_faces [F, 3], j_regressor [35, V]
    float64, part_dict {name: fine vertex indices} (17 y-bands) and the
    girth rings ([16, n_theta] vertex ids)."""

    def __init__(self, n_theta: int = 53, n_phi: int = 130):
        self.template_verts, self.template_faces = _capsule(n_theta, n_phi)
        v = self.template_verts
        y = v[:, 1]
        order = np.argsort(y, kind="stable")
        self.part_dict = {name: np.sort(idx).astype(np.int64) for name, idx
                          in zip(PART_LIST, np.array_split(order, N_PARTS))}
        rng = np.random.default_rng(0)
        jreg = np.zeros((N_KPS_FULL, len(v)))
        depth = np.zeros(N_KPS_FULL)
        for a, b in NEWSKL_LIST:
            depth[b] = depth[a] + 1.0
        for j in range(N_KPS_FULL):
            t = 0.5 - 0.4 * (depth[j] / max(depth.max(), 1.0)) \
                + 0.05 * rng.standard_normal()
            target_y = y.min() + (y.max() - y.min()) * (0.5 + t / 2)
            ang = 2.0 * np.pi * j / N_KPS_FULL
            target = np.array([0.15 * np.cos(ang), target_y,
                               0.15 * np.sin(ang)])
            nearest = np.argsort(np.linalg.norm(v - target[None], axis=1))[:24]
            jreg[j, nearest] = 1.0 / len(nearest)
        self.j_regressor = jreg
        vid = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
        rings = np.linspace(10, n_phi - 10, 16).astype(int)
        self.rings = np.stack([vid[:, p] for p in rings])
        self.girth_edges = [np.stack([r, np.roll(r, -1)], axis=1)
                            for r in self.rings]
        self.girth_factors = [np.zeros((len(r), 1)) for r in self.rings]

    def meshes(self, n: int, seed: int, device) -> torch.Tensor:
        """[n, V, 3] float32 on `device`: smooth radial and bend fields of
        four parameters a mesh, drawn from `seed`, over the template."""
        a = np.random.default_rng(seed).uniform(-0.12, 0.12, size=(n, 4))
        v0 = torch.as_tensor(self.template_verts, device=device)
        y01 = (v0[:, 1] - v0[:, 1].min()) / (v0[:, 1].max() - v0[:, 1].min())
        theta = torch.atan2(v0[:, 2], v0[:, 0])
        a = torch.as_tensor(a, device=device)[:, :, None]
        radial = (1.0 + a[:, 0] * torch.sin(math.pi * y01)
                  + a[:, 1] * torch.sin(2 * math.pi * y01)
                  + a[:, 2] * torch.cos(theta) * y01 * (1 - y01))
        bend = a[:, 3] * torch.sin(math.pi * y01)
        out = torch.stack([v0[:, 0] * radial + 0.3 * bend,
                           v0[:, 1].expand_as(radial),
                           v0[:, 2] * radial], dim=-1)
        return out.float()

    def measures(self, verts: torch.Tensor) -> torch.Tensor:
        """[n, V, 3] -> [n, 32] float32: 16 girths (closed ring perimeters)
        and the 16 bone lengths of MEASURE_SKL_LIST."""
        v = verts.double()
        ring = v[:, torch.as_tensor(self.rings, device=v.device)]
        girth = torch.linalg.vector_norm(
            ring - torch.roll(ring, -1, dims=2), dim=-1).sum(dim=2)
        jreg = torch.as_tensor(self.j_regressor, device=v.device)
        kps = torch.einsum("jv,nvd->njd", jreg, v)
        a, b1, b2 = (torch.as_tensor(i, device=v.device, dtype=torch.long)
                     for i in bone_endpoint_arrays(MEASURE_SKL_LIST))
        bone = kps[:, a] - 0.5 * (kps[:, b1] + kps[:, b2])
        return torch.cat([girth, torch.linalg.vector_norm(bone, dim=-1)],
                         dim=1).float()


def _fan_ins(tree) -> list:
    """The fan-in of every leaf, in tree order: a {"w", "b"} pair shares
    its weight's second-to-last size (a [P, K, N] head: K)."""
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        return [int(tree["w"].shape[-2])] * 2
    if isinstance(tree, dict):
        return [f for v in tree.values() for f in _fan_ins(v)]
    return [f for v in tree for f in _fan_ins(v)]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, it) for v in like]
    return next(it)


def make_params(like, seed: int, device) -> dict:
    """A tree shaped like `like` (shapes only are read) of contiguous
    float32 leaves on `device`: one uniform draw from a generator seeded
    with `seed`, split into the leaves and scaled by 1/sqrt(fan_in)."""
    leaves = _leaves(like)
    sizes = [int(x.numel()) for x in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = []
    for x, fan, part in zip(leaves, _fan_ins(like), torch.split(u, sizes)):
        out.append((part / math.sqrt(max(fan, 1))).reshape(x.shape)
                   .contiguous())
    return _rebuild(like, iter(out))
