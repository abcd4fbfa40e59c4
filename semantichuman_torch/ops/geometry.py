"""Differential geometry on a triangle mesh (counterpart of
`semantichuman_tpu/ops/geometry.py`): the cotangent Laplace-Beltrami
operator, lumped mass, enclosed volume, geodesic distance by the heat
method, the spectral basis and the biharmonic distance.

Every operator is matrix-free: the face corners come from one row gather of
the flat face list (`ops/row_gather.py`, row 7 on the card), and every sum
over the faces around a vertex is a fixed-order CSR reduce
(`ops/csr_reduce.py`, row 8 on the card) over tables built once per face
list (`MeshTables`), so the card's results repeat bit for bit (an
`index_add_` adds in the order its atomics land).  Linear systems are
solved by conjugate gradients with the JAX package's stopping rule.
Off the training path.  The vertex values, the gathers, the reduces and
the CG vectors are float32; the per-face geometry (cross products, dots,
norms, the face gradient) and the scalar reductions (dot products, means)
are computed in float64 and rounded once to float32.  The heat method's
CG runs 200 iterations that do not converge, which amplify the last bit
of the operator's coefficients and scalars, and the card rounds float32
arithmetic otherwise than the host (its elementwise kernels contract
a*b - c*d into fused multiply-adds; its sums take another order): in
float64 both round to the same float32 values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr_reduce import CSRTable, csr_reduce, inverse_csr
from .row_gather import GatherTable, gather_rows


@dataclass(frozen=True)
class MeshTables:
    """The gather and reduce tables of one face list, built once on the
    host: `corners` gathers the flat faces [3F] (face-major) from the V
    vertex rows, and its inverse sums a value per corner into its vertex;
    `edges` sums 6F signed entries, +c_k into vertex f[:, k+1] and -c_k
    into f[:, k+2] for k = 0, 1, 2 (the cotan stencil's two ends of the
    edge opposite corner k)."""
    faces: torch.Tensor         # [F, 3] int64
    corners: GatherTable
    edges: CSRTable
    n_verts: int

    @staticmethod
    def build(faces, n_verts: int, device) -> "MeshTables":
        f = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor)
                       else faces, np.int64)
        if f.ndim != 2 or f.shape[1] != 3:
            raise ValueError(f"faces of shape {f.shape}: expected [F, 3]")
        ends = np.concatenate([f[:, 1], f[:, 2], f[:, 0],
                               f[:, 2], f[:, 0], f[:, 1]])
        offs, cols = inverse_csr(ends, n_verts)
        return MeshTables(
            faces=torch.as_tensor(f, device=device),
            corners=GatherTable.build(f.reshape(-1), n_verts, device),
            edges=CSRTable.build(offs, cols, n_src=len(ends), device=device),
            n_verts=int(n_verts))


def _corners(x: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """x [V, C] -> [F, 3, C], the rows of each face's three corners."""
    g = gather_rows(x.float().contiguous()[None], mt.corners)[0]
    return g.reshape(-1, 3, x.shape[1])


def _to_vertices(per_corner: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """[F, 3, C] values at the corners -> [V, C] their sums at the
    vertices."""
    g = per_corner.reshape(1, -1, per_corner.shape[-1]).contiguous()
    return csr_reduce(g, mt.corners.inverse)[0]


def _edge_sums(c: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """c [F, 3, C] (c[:, k] weighs the edge opposite corner k) ->
    [V, C]: +c_k summed into f[:, k+1], -c_k into f[:, k+2]."""
    cs = c.transpose(0, 1).reshape(-1, c.shape[-1])           # [3F, C]
    g = torch.cat([cs, -cs]).contiguous()[None]
    return csr_reduce(g, mt.edges)[0]


# --- primitives ----------------------------------------------------------------

def _areas_normals(p: torch.Tensor):
    """Corners [F, 3, 3] float64 -> (areas [F], unit normals [F, 3]),
    float64."""
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return 0.5 * nn[:, 0], n / torch.clamp(nn, min=1e-30)


def face_areas_normals(verts: torch.Tensor, mt: MeshTables):
    """verts [V, 3] -> (areas [F], unit normals [F, 3])."""
    areas, normals = _areas_normals(_corners(verts, mt).double())
    return areas.float(), normals.float()


def _cotans(p: torch.Tensor) -> torch.Tensor:
    """Corners [F, 3, 3] -> [F, 3] float32 half-cotangents of each
    corner's angle (computed in float64)."""
    p = p.double()
    cots = []
    for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        u, w = p[:, b] - p[:, a], p[:, c] - p[:, a]
        cross = torch.linalg.vector_norm(torch.linalg.cross(u, w, dim=-1),
                                         dim=-1)
        cots.append(torch.sum(u * w, dim=-1) / torch.clamp(cross, min=1e-30))
    return (0.5 * torch.stack(cots, dim=-1)).float()


def cotan_weights(verts: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """Per-face cotangents [F, 3]: entry k is half the cot of the angle at
    corner k, the weight of the opposite edge (the cotan stencil)."""
    return _cotans(_corners(verts, mt))


def lumped_mass(verts: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """Barycentric lumped mass [V]: a third of each incident face's area."""
    areas, _ = face_areas_normals(verts, mt)
    per = (areas / 3.0)[:, None, None].expand(-1, 3, 1)
    return _to_vertices(per, mt)[:, 0]


def _laplacian(cots: torch.Tensor, mt: MeshTables,
               x: torch.Tensor) -> torch.Tensor:
    """L x from the cotangents [F, 3]; x [V] or [V, C]."""
    xc = x[:, None] if x.dim() == 1 else x
    xs = _corners(xc, mt)                                  # [F, 3, C]
    # corner k weighs edge (i, j) = (k+1, k+2): w_k (x_j - x_i) at i
    diff = torch.roll(xs, -2, dims=1) - torch.roll(xs, -1, dims=1)
    out = _edge_sums(cots[:, :, None] * diff, mt)
    return out[:, 0] if x.dim() == 1 else out


def laplacian_apply(verts: torch.Tensor, mt: MeshTables,
                    x: torch.Tensor) -> torch.Tensor:
    """(L x) for the cotan Laplacian, matrix-free; x [V] or [V, C].  L is
    negative semidefinite: (L x)_i = sum_j w_ij (x_j - x_i),
    w_ij = (cot a_ij + cot b_ij) / 2."""
    return _laplacian(cotan_weights(verts, mt), mt, x)


def vf_adjacency(faces: np.ndarray, n_verts: int):
    """Host helper: vertex -> incident-face COO arrays (rows [3F] vertex
    ids, cols [3F] face ids), int32."""
    faces = np.asarray(faces)
    rows = faces.reshape(-1)
    cols = np.repeat(np.arange(len(faces)), 3)
    return rows.astype(np.int32), cols.astype(np.int32)


def mesh_volume(verts: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """Signed enclosed volume by the divergence theorem (a 0-d tensor)."""
    p = _corners(verts, mt).double()
    cross = torch.linalg.cross(p[:, 1], p[:, 2], dim=-1)
    return (torch.sum(torch.sum(p[:, 0] * cross, dim=-1)) / 6.0).float()


# --- conjugate gradients --------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b accumulated in float64, rounded once to float32."""
    return torch.dot(a.double(), b.double()).float()


def _mean(a: torch.Tensor) -> torch.Tensor:
    """The mean accumulated in float64, rounded once to float32."""
    return a.double().mean().float()


def cg(apply_a, b: torch.Tensor, maxiter: int, tol: float = 1e-8,
       atol: float = 0.0) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A from x = 0: the
    iteration of `jax.scipy.sparse.linalg.cg` without a preconditioner,
    run while r.r > max(tol^2 b.b, atol^2) and fewer than maxiter
    iterations have run (the host reads r.r once an iteration).  The dot
    products accumulate in float64 (`_dot`)."""
    x = torch.zeros_like(b)
    atol2 = torch.clamp(tol * tol * _dot(b, b), min=atol * atol)
    r = b - apply_a(x)
    p = r
    gamma = _dot(r, r)
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        ap = apply_a(p)
        alpha = gamma / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = _dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


# --- geodesics in heat (Crane et al.) -------------------------------------------

def geodesics_in_heat(verts: torch.Tensor, mt: MeshTables,
                      source_onehot: torch.Tensor, t_factor: float = 1.0,
                      cg_iters: int = 200) -> torch.Tensor:
    """Geodesic distance [V] from the source vertices (source_onehot [V],
    1.0 at a source) by the heat method, t = t_factor * mean edge length^2:

      1. heat diffusion     (M - t L) u = delta     (CG)
      2. normalized field   X = -grad u / |grad u|  (per face)
      3. Poisson recovery   L phi = div X           (CG, shifted)
    """
    verts = verts.float()
    src = source_onehot.float()
    p = _corners(verts, mt)                                # [F, 3, 3]
    pd = p.double()
    elen = torch.linalg.vector_norm(pd - torch.roll(pd, -1, dims=1), dim=-1)
    t = (t_factor * elen.mean() ** 2).float()
    cots = _cotans(p)
    mass = lumped_mass(verts, mt)

    def heat_op(u):
        return mass * u - t * _laplacian(cots, mt, u)

    u = cg(heat_op, src * mass, maxiter=cg_iters)

    # the face gradient of u: (1/2A) sum_k u_k (n x e_k), e_k the edge
    # opposite corner k, from corner k+1 to k+2
    areas, normals = _areas_normals(pd)
    uk = _corners(u[:, None], mt)[:, :, 0].double()        # [F, 3]
    e = torch.roll(pd, -2, dims=1) - torch.roll(pd, -1, dims=1)
    grad = torch.zeros_like(normals)
    for k in range(3):
        grad = grad + uk[:, k, None] * torch.linalg.cross(normals, e[:, k],
                                                          dim=-1)
    grad = grad / torch.clamp(2.0 * areas[:, None], min=1e-30)
    # far from the source u underflows in float32 and |grad u| collapses:
    # normalizing there would make large junk vectors, so the field is
    # zero wherever the gradient is numerically dead
    gn = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    field = torch.where(gn > 1e-12, -grad / torch.clamp(gn, min=1e-12),
                        torch.zeros_like(grad))

    # integrated divergence: at vertex i, cot_k (X . (v_j - v_i)) over the
    # edge (i, j) opposite corner k
    dots = torch.sum(field[:, None, :] * e, dim=-1) * cots.double()
    div = _edge_sums(dots.float()[:, :, None], mt)[:, 0]

    # L is singular (the constants): project them out of the right-hand
    # side and shift by a mass-scaled multiple of the identity, so CG stays
    # bounded on skinny triangles
    div = div - _mean(div)
    shift = 1e-6 * _mean(mass)

    def lap_op(phi):
        return -_laplacian(cots, mt, phi) + shift * phi

    phi = cg(lap_op, -div, maxiter=cg_iters)
    phi = phi - _mean(phi)
    phi = phi - (torch.sum(phi.double() * src.double()).float()
                 / torch.clamp(torch.sum(src), min=1.0))
    return torch.abs(phi)


# --- spectral tools --------------------------------------------------------------

def laplacian_dense(verts: torch.Tensor, mt: MeshTables) -> torch.Tensor:
    """The dense [V, V] cotan Laplacian, column c = L e_c (for spectral
    analysis of small and coarse meshes)."""
    n = verts.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=verts.device)
    return laplacian_apply(verts, mt, eye)


def spectral_basis(verts: torch.Tensor, mt: MeshTables, k: int):
    """The first k eigenpairs of the mass-normalized Laplace-Beltrami
    operator: (eigenvalues [k] ascending, eigenvectors [V, k],
    M-orthonormal), from torch.linalg.eigh of -M^-1/2 L M^-1/2."""
    mass = lumped_mass(verts, mt)
    inv_sqrt_m = 1.0 / torch.sqrt(torch.clamp(mass, min=1e-30))
    lap = laplacian_dense(verts, mt)
    a = -(inv_sqrt_m[:, None] * lap * inv_sqrt_m[None, :])
    a = 0.5 * (a + a.T)
    w, u = torch.linalg.eigh(a)
    return w[:k], inv_sqrt_m[:, None] * u[:, :k]


def biharmonic_distance(verts: torch.Tensor, mt: MeshTables, k: int = 64,
                        eps: float = 1e-8) -> torch.Tensor:
    """[V, V] biharmonic distances (Lipman et al.): d(i, j)^2 =
    sum_k (phi_k(i) - phi_k(j))^2 / lambda_k^2 over the nonzero eigenpairs
    of the first k."""
    w, phi = spectral_basis(verts, mt, k)
    w, phi = w[1:], phi[:, 1:]                  # drop the constant mode
    g = phi / torch.clamp(w[None, :], min=eps)
    sq = torch.sum(g * g, dim=1)
    d2 = sq[:, None] - 2.0 * (g @ g.T) + sq[None, :]
    return torch.sqrt(torch.clamp(d2, min=0.0))
