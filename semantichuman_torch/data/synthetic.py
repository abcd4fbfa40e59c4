"""Synthetic SMPL-shaped human assets (the port's copy of
`semantichuman_tpu/data/synthetic.py`).

A closed genus-0 template with the SMPL vertex count, a 17-part partition, a
35-keypoint regressor, girth-measurement edge rings, a deformable sample
generator and the 32-d body measures.  Every array equals
the JAX package's bit for bit: the bundled topology
(`assets/topology_synth_full_2222.npz`) was compiled from this template.
"""

from __future__ import annotations

import numpy as np

from ..constants import (MEASURE_SKL_LIST, N_KPS_FULL, N_PARTS, NEWSKL_LIST,
                         PART_LIST)
from .measure_np import bone_lengths_np, girths_np


def uv_capsule(n_theta: int = 64, n_phi: int = 109, radius_fn=None):
    """Closed UV-parameterized surface of revolution around +y, deformable by
    radius_fn(y01, theta).  Vertex count = n_theta * n_phi + 2 (two poles)."""
    if radius_fn is None:
        def radius_fn(y01, theta):
            return 0.25 + 0.05 * np.sin(3 * np.pi * y01)
    thetas = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    ys = np.linspace(0.0, 1.0, n_phi + 2)[1:-1]
    grid_t, grid_y = np.meshgrid(thetas, ys, indexing="ij")  # [T, P]
    r = radius_fn(grid_y, grid_t)
    # taper to zero at the poles so the surface closes smoothly
    taper = np.sqrt(np.clip(np.sin(np.pi * grid_y), 1e-3, None))
    r = r * taper
    x = r * np.cos(grid_t)
    z = r * np.sin(grid_t)
    y = grid_y * 1.8 - 0.9
    ring_verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)  # [T*P, 3]

    south = np.array([[0.0, -0.9, 0.0]])
    north = np.array([[0.0, 0.9, 0.0]])
    verts = np.concatenate([ring_verts, south, north], axis=0)
    vid = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    s_id = n_theta * n_phi
    n_id = s_id + 1

    faces = []
    for t in range(n_theta):
        t2 = (t + 1) % n_theta
        for p in range(n_phi - 1):
            a, b = vid[t, p], vid[t2, p]
            c, d = vid[t, p + 1], vid[t2, p + 1]
            faces.append([a, b, c])
            faces.append([b, d, c])
        faces.append([vid[t2, 0], vid[t, 0], s_id])
        faces.append([vid[t, n_phi - 1], vid[t2, n_phi - 1], n_id])
    return verts, np.asarray(faces, dtype=np.int32)


def _human_radius(y01, theta):
    """A lumpy, asymmetric body-like profile (head bulge, shoulders, hips)."""
    base = (0.16
            + 0.10 * np.exp(-((y01 - 0.92) / 0.05) ** 2)    # head
            + 0.16 * np.exp(-((y01 - 0.70) / 0.12) ** 2)    # chest/shoulders
            + 0.14 * np.exp(-((y01 - 0.45) / 0.10) ** 2)    # hips
            + 0.05 * np.exp(-((y01 - 0.15) / 0.08) ** 2))   # calves
    lobes = 1.0 + 0.25 * np.cos(2 * theta) * np.exp(-((y01 - 0.3) / 0.25) ** 2)
    return base * lobes


class SyntheticHuman:
    """Synthetic SMPL-shaped asset bundle: template_verts [V, 3],
    template_faces [F, 3], J_regressor [35, V], part_dict {name: fine vertex
    indices} (17 parts)."""

    N_THETA = 53
    N_PHI = 130   # 53*130 + 2 = 6892 ≈ SMPL's 6890

    def __init__(self, n_theta: int | None = None, n_phi: int | None = None):
        n_theta = n_theta or self.N_THETA
        n_phi = n_phi or self.N_PHI
        self.template_verts, self.template_faces = uv_capsule(
            n_theta, n_phi, _human_radius)
        self.n_theta, self.n_phi = n_theta, n_phi
        V = len(self.template_verts)

        # parts: 17 y-bands (deterministic partition of all vertices)
        y = self.template_verts[:, 1]
        order = np.argsort(y, kind="stable")
        splits = np.array_split(order, N_PARTS)
        self.part_dict = {name: np.sort(idx).astype(np.int64)
                          for name, idx in zip(PART_LIST, splits)}

        # J_regressor: joint j = mean of a local vertex cluster, arranged so
        # the NEWSKL_LIST tree has strictly positive bone lengths
        rng = np.random.default_rng(0)
        J = np.zeros((N_KPS_FULL, V))
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
            d = np.linalg.norm(self.template_verts - target[None], axis=1)
            nearest = np.argsort(d)[:24]
            J[j, nearest] = 1.0 / len(nearest)
        self.J_regressor = J.astype(np.float64)

        # girth polylines: one ring of edges per measured part (16 entries)
        self.girth_edges = []
        self.girth_factors = []
        vid = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
        rings = np.linspace(10, n_phi - 10, 16).astype(int)
        for ring_p in rings:
            ring_ids = vid[:, ring_p]
            e = np.stack([ring_ids, np.roll(ring_ids, -1)], axis=1)
            self.girth_edges.append(e.astype(np.int64))
            self.girth_factors.append(np.zeros((len(e), 1)))

    def sample_meshes(self, n: int, seed: int = 0) -> np.ndarray:
        """[n, V, 3] smoothly deformed variants of the template (random
        low-frequency radial + bend fields), mimicking posed/shaped bodies."""
        rng = np.random.default_rng(seed)
        v0 = self.template_verts
        y01 = (v0[:, 1] - v0[:, 1].min()) / np.ptp(v0[:, 1])
        theta = np.arctan2(v0[:, 2], v0[:, 0])
        out = np.empty((n, len(v0), 3), dtype=np.float64)
        for i in range(n):
            a = rng.uniform(-0.12, 0.12, size=4)
            radial = (1.0 + a[0] * np.sin(np.pi * y01)
                      + a[1] * np.sin(2 * np.pi * y01)
                      + a[2] * np.cos(theta) * y01 * (1 - y01))
            bend = a[3] * np.sin(np.pi * y01)
            v = v0.copy()
            center = np.array([0.0, 0.0, 0.0])
            rad_vec = v - center
            rad_vec[:, 1] = 0.0
            v[:, [0, 2]] = center[[0, 2]] + rad_vec[:, [0, 2]] * radial[:, None]
            v[:, 0] += bend * 0.3
            out[i] = v
        return out

    def measures(self, verts_batch: np.ndarray) -> np.ndarray:
        """[N, 32] measure vectors: 16 girths + 16 bone lengths."""
        out = np.empty((len(verts_batch), 32))
        for i, v in enumerate(verts_batch):
            g = girths_np(v, self.girth_factors, self.girth_edges)
            kps = self.J_regressor @ v
            ln = bone_lengths_np(kps, MEASURE_SKL_LIST)
            out[i] = np.concatenate([g, ln])
        return out
