"""The port's geometry (`semantichuman_torch/ops/geometry.py`, and
`ops/distance.py`'s vertex_normals and total_mesh_volume) against the JAX
package's on the same icosphere, and the analytic checks of
tests/test_geometry.py repeated on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.data.synthetic import icosphere as torch_icosphere
from semantichuman_torch.ops import distance as TD
from semantichuman_torch.ops import geometry as TG
from semantichuman_tpu.data.synthetic import icosphere as jax_icosphere
from semantichuman_tpu.ops import distance as JD
from semantichuman_tpu.ops import geometry as JG

torch.set_num_threads(1)


@pytest.mark.parametrize("subdiv", [0, 1, 3])
def test_icosphere_equals_jax(subdiv):
    tv, tf = torch_icosphere(subdiv, radius=1.5)
    jv, jf = jax_icosphere(subdiv, radius=1.5)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == jf.dtype


@pytest.fixture(scope="module")
def sphere():
    """icosphere(3), 642 vertices: (port verts, tables, JAX verts, faces)."""
    v, f = torch_icosphere(subdiv=3)
    tv = torch.as_tensor(v, dtype=torch.float32)
    mt = TG.MeshTables.build(f, len(v), "cpu")
    return tv, mt, jnp.asarray(v, jnp.float32), jnp.asarray(f)


def _x(n, c=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if c is None else (n, c)).astype(
        np.float32)


# name -> (port function, JAX function); each takes (verts, faces) in its
# package's form and returns a tuple of arrays
OPS = {
    "face_areas_normals": (TG.face_areas_normals, JG.face_areas_normals),
    "cotan_weights": (lambda v, f: (TG.cotan_weights(v, f),),
                      lambda v, f: (JG.cotan_weights(v, f),)),
    "lumped_mass": (lambda v, f: (TG.lumped_mass(v, f),),
                    lambda v, f: (JG.lumped_mass(v, f),)),
    "laplacian_apply_vector": (
        lambda v, f: (TG.laplacian_apply(v, f, torch.as_tensor(
            _x(642))),),
        lambda v, f: (JG.laplacian_apply(v, f, jnp.asarray(_x(642))),)),
    "laplacian_apply_channels": (
        lambda v, f: (TG.laplacian_apply(v, f, torch.as_tensor(
            _x(642, 5))),),
        lambda v, f: (JG.laplacian_apply(v, f, jnp.asarray(_x(642, 5))),)),
    "mesh_volume": (lambda v, f: (TG.mesh_volume(v, f),),
                    lambda v, f: (JG.mesh_volume(v, f),)),
    "laplacian_dense": (lambda v, f: (TG.laplacian_dense(v, f),),
                        lambda v, f: (JG.laplacian_dense(v, f),)),
    "vertex_normals": (
        lambda v, f: (TD.vertex_normals(v[None] * torch.tensor(
            [1.0, 0.5, 2.0]), f.corners),),
        lambda v, f: (JD.vertex_normals(v[None] * jnp.asarray(
            [1.0, 0.5, 2.0]), f),)),
    "total_mesh_volume": (
        lambda v, f: (TD.total_mesh_volume(torch.stack([v, 0.5 * v]),
                                           f.corners),),
        lambda v, f: (JD.total_mesh_volume(jnp.stack([v, 0.5 * v]), f),)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_matches_jax(sphere, name):
    """Elementwise and matrix-free operators: within 1e-5 of the output's
    largest entry (f32 sums over a vertex's faces in another order)."""
    tv, mt, jv, jf = sphere
    port, ref = OPS[name]
    for a, b in zip(port(tv, mt), ref(jv, jf)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, name


def test_geodesics_in_heat_matches_jax(sphere):
    """The heat method's field from vertex 0, 200 CG iterations each
    solve: within 1e-3 of the field's largest value.  The CG stopping rule
    (r.r <= tol^2 b.b, tol 1e-8, atol 0) is JAX's, so both run the same
    number of iterations."""
    tv, mt, jv, jf = sphere
    src = np.zeros(642, np.float32)
    src[0] = 1.0
    got = TG.geodesics_in_heat(tv, mt, torch.as_tensor(src)).numpy()
    want = np.asarray(JG.geodesics_in_heat(jv, jf, jnp.asarray(src)))
    assert float(np.abs(got - want).max()) <= 1e-3 * float(want.max())


def test_cg_stops_as_jax():
    """A system that converges before maxiter: the port's CG and JAX's
    stop at the same iterate (within f32 rounding)."""
    import jax.scipy.sparse.linalg as jsl
    rng = np.random.default_rng(3)
    q = rng.standard_normal((12, 12)).astype(np.float32)
    a = q @ q.T + 12 * np.eye(12, dtype=np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ta = torch.as_tensor(a)
    for tol, it in ((1e-3, 50), (1e-8, 4)):
        got = TG.cg(lambda x: ta @ x, torch.as_tensor(b), maxiter=it,
                    tol=tol).numpy()
        want, _ = jsl.cg(lambda x: jnp.asarray(a) @ x, jnp.asarray(b),
                         tol=tol, maxiter=it)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


# the sphere's eigenspaces: l(l+1) with multiplicity 2l+1 (l = 0, 1, 2)
CLUSTERS = ((0, 1), (1, 4), (4, 9))


def test_spectral_basis_matches_jax(sphere):
    """The nonzero eigenvalues to rtol 1e-4, and the zero mode below
    1e-4 in both (float32 eigh leaves it at about 1e-5 of noise either
    side of 0, tests/test_geometry.py's bound); the eigenvectors by the
    subspace each near-degenerate cluster spans: the cosines of its
    principal angles to JAX's, in the M inner product, within 1e-4 of 1."""
    tv, mt, jv, jf = sphere
    tw, tphi = (a.numpy() for a in TG.spectral_basis(tv, mt, 9))
    jw, jphi = (np.asarray(a) for a in JG.spectral_basis(jv, jf, 9))
    np.testing.assert_allclose(tw[1:], jw[1:], rtol=1e-4)
    assert max(abs(tw[0]), abs(jw[0])) < 1e-4
    m = np.asarray(JG.lumped_mass(jv, jf))
    for lo, hi in CLUSTERS:
        cos = np.linalg.svd(tphi[:, lo:hi].T @ (m[:, None] * jphi[:, lo:hi]),
                            compute_uv=False)
        np.testing.assert_allclose(cos, 1.0, atol=1e-4)


def test_biharmonic_distance_matches_jax(sphere):
    """k = 36 (the eigenspaces l <= 5 whole, so the sum does not depend on
    which vectors of a degenerate cluster eigh returns): within 1e-3 of
    the largest distance."""
    tv, mt, jv, jf = sphere
    got = TG.biharmonic_distance(tv, mt, k=36).numpy()
    want = np.asarray(JG.biharmonic_distance(jv, jf, k=36))
    assert float(np.abs(got - want).max()) <= 1e-3 * float(want.max())


# --- tests/test_geometry.py's analytic checks, on the port ------------------------

def _areas_sum(tv, mt):
    areas, normals = TG.face_areas_normals(tv, mt)
    assert float(areas.sum()) == pytest.approx(4 * np.pi, rel=0.02)
    np.testing.assert_allclose(np.linalg.norm(normals.numpy(), axis=1), 1.0,
                               atol=1e-5)


def _volume(tv, mt):
    assert float(TG.mesh_volume(tv, mt)) == pytest.approx(4 / 3 * np.pi,
                                                          rel=0.03)


def _constants(tv, mt):
    np.testing.assert_allclose(
        TG.laplacian_apply(tv, mt, torch.ones(642)).numpy(), 0.0, atol=1e-4)


def _symmetric(tv, mt):
    x, y = torch.as_tensor(_x(642, seed=0)), torch.as_tensor(_x(642, seed=1))
    lhs = float(torch.sum(y * TG.laplacian_apply(tv, mt, x)))
    rhs = float(torch.sum(x * TG.laplacian_apply(tv, mt, y)))
    assert lhs == pytest.approx(rhs, rel=1e-3, abs=1e-3)


def _nsd(tv, mt):
    for seed in range(3):
        x = torch.as_tensor(_x(642, seed=seed + 1))
        assert float(torch.sum(x * TG.laplacian_apply(tv, mt, x))) <= 1e-3


def _mass(tv, mt):
    areas, _ = TG.face_areas_normals(tv, mt)
    assert float(TG.lumped_mass(tv, mt).sum()) == pytest.approx(
        float(areas.sum()), rel=1e-5)


def _vf(tv, mt):
    f = mt.faces.numpy()
    rows, cols = TG.vf_adjacency(f, 642)
    assert len(rows) == len(cols) == 3 * len(f)
    assert set(f[5]) == set(rows[cols == 5])


def _arc_length(tv, mt):
    src = torch.zeros(642)
    src[0] = 1.0
    d = TG.geodesics_in_heat(tv, mt, src, cg_iters=300).numpy()
    v = tv.numpy()
    truth = np.arccos(np.clip(v @ v[0], -1.0, 1.0))
    assert np.abs(d - truth).mean() < 0.10
    assert d[0] == pytest.approx(0.0, abs=0.05)
    assert d[int(np.argmax(truth))] == pytest.approx(np.pi, rel=0.12)


def _elongated(tv, mt):
    from semantichuman_torch.data.synthetic import SyntheticHuman
    sh = SyntheticHuman(n_theta=16, n_phi=40)
    v = torch.as_tensor(sh.template_verts, dtype=torch.float32)
    m = TG.MeshTables.build(sh.template_faces, len(v), "cpu")
    src = torch.zeros(len(v))
    src[0] = 1.0
    d = TG.geodesics_in_heat(v, m, src, cg_iters=400).numpy()
    assert np.isfinite(d).all()
    assert d.max() < 4 * float(np.linalg.norm(np.ptp(sh.template_verts, 0)))


def _spectral(tv, mt):
    w, phi = (a.numpy() for a in TG.spectral_basis(tv, mt, 10))
    assert abs(w[0]) < 1e-4
    assert np.all(np.diff(w) > -1e-5)
    np.testing.assert_allclose(w[1:4], 2.0, rtol=0.05)
    m = TG.lumped_mass(tv, mt).numpy()
    np.testing.assert_allclose(phi.T @ (m[:, None] * phi), np.eye(10),
                               atol=5e-3)


def _biharmonic(tv, mt):
    d = TG.biharmonic_distance(tv, mt, k=32).numpy()
    assert d.shape == (642, 642)
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-3)
    np.testing.assert_allclose(d, d.T, atol=1e-5)
    assert np.all(d >= 0)
    cosang = np.clip(tv.numpy() @ tv.numpy()[0], -1, 1)
    near, far = int(np.argsort(-cosang)[1]), int(np.argmin(cosang))
    assert d[0, far] > 3 * d[0, near]


def _normals(tv, mt):
    n = TD.vertex_normals(tv[None], mt.corners)[0].numpy()
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    assert np.sum(n * tv.numpy(), axis=1).min() > 0.99


ANALYTIC = {"areas_sum_to_sphere_area": _areas_sum,
            "volume_of_unit_sphere": _volume,
            "laplacian_annihilates_constants": _constants,
            "laplacian_symmetric": _symmetric,
            "laplacian_negative_semidefinite": _nsd,
            "lumped_mass_totals_area": _mass, "vf_adjacency": _vf,
            "geodesics_match_arc_length": _arc_length,
            "geodesics_bounded_on_elongated_mesh": _elongated,
            "spectral_basis_properties": _spectral,
            "biharmonic_distance_is_metric_like": _biharmonic,
            "vertex_normals_radial_on_sphere": _normals}


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic(sphere, name):
    """tests/test_geometry.py's checks, each with its tolerances."""
    ANALYTIC[name](sphere[0], sphere[1])


def test_tables_reject_a_bad_face_list():
    with pytest.raises(ValueError, match=r"expected \[F, 3\]"):
        TG.MeshTables.build(np.zeros((4, 4), np.int64), 5, "cpu")
    with pytest.raises(ValueError, match="outside"):
        TG.MeshTables.build(np.array([[0, 1, 7]]), 5, "cpu")
