"""The port's topology compiler against the JAX package's: the compiled
hierarchy array for array (the small human against the JAX compile and the
golden fixture, the SMPL-scale synthetic template against the committed
`assets/topology_synth_full_2222.npz`), the pre-decimated-meshes path, the
nearest-point queries (native and NumPy), the reference-pickle import, the
OBJ reader and the compile cache's key policy, on the CPU."""

import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from semantichuman_torch.topology import compile_topology, compiler
from semantichuman_torch.topology import hierarchy as TH
from semantichuman_torch.topology import nearest as TN
from semantichuman_torch.topology import obj_io as TO
from semantichuman_torch.topology import reference_import as TR
from semantichuman_tpu.topology import hierarchy as JH
from semantichuman_tpu.topology import nearest as JN
from semantichuman_tpu.topology import obj_io as JO
from semantichuman_tpu.topology import reference_import as JR

ROOT = Path(__file__).resolve().parents[1]
FIELDS_PER_LEVEL = ("verts", "faces", "spirals")
FIELDS_PER_TRANSITION = ("pool_idx", "unpool_idx", "unpool_w")


def assert_hierarchies_equal(got, want):
    """Every table of two MeshHierarchy objects equal, dtype and all."""
    assert got.sizes == want.sizes
    assert got.spiral_sizes == want.spiral_sizes
    assert got.reference_points == want.reference_points
    for name in FIELDS_PER_LEVEL + FIELDS_PER_TRANSITION:
        for l, (a, b) in enumerate(zip(getattr(got, name),
                                       getattr(want, name))):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (name, l, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{l}]")
    np.testing.assert_array_equal(got.coarse_to_fine, want.coarse_to_fine)
    assert got.coarse_to_fine.dtype == want.coarse_to_fine.dtype


@pytest.fixture(scope="module")
def port_small(small_human, tmp_path_factory):
    """The port's compile of the conftest's small human (anchor vertex 0,
    as its `small_hierarchy` fixture compiles it for the JAX package)."""
    cache = tmp_path_factory.mktemp("port_topo") / "hier.npz"
    return compile_topology(
        small_human.template_verts, small_human.template_faces,
        ds_factors=(2, 2, 2, 2), step_sizes=(2, 2, 1, 1, 1),
        dilation=(2, 2, 1, 1, 1), reference_vertex=0, cache_path=str(cache))


def test_compile_matches_jax(port_small, small_hierarchy):
    assert_hierarchies_equal(port_small, small_hierarchy)


def test_compile_matches_golden_fixture(port_small):
    """The spiral order fixes the conv weight layout: it must equal the
    golden tables the JAX package's own test holds."""
    golden = np.load(ROOT / "tests" / "golden" / "small_human_topology.npz")
    h = port_small
    for l in range(h.n_levels):
        np.testing.assert_array_equal(h.spirals[l], golden[f"spirals_{l}"])
    for l in range(h.n_levels - 1):
        np.testing.assert_array_equal(h.pool_idx[l], golden[f"pool_{l}"])
        np.testing.assert_array_equal(h.unpool_idx[l],
                                      golden[f"unpool_idx_{l}"])
        np.testing.assert_array_equal(h.unpool_w[l],
                                      golden[f"unpool_w_{l}"])


def test_full_scale_compile_matches_bundled_artifact(tmp_path):
    """The SMPL-scale synthetic template (6892 vertices) compiles to the
    committed artifact array for array, and to its .meta key (~6 s)."""
    from semantichuman_torch.data.synthetic import SyntheticHuman

    sh = SyntheticHuman()
    cache = str(tmp_path / "topology_2222.npz")
    compile_topology(sh.template_verts, sh.template_faces,
                     reference_vertex=414, cache_path=cache)
    bundled = ROOT / "assets" / "topology_synth_full_2222.npz"
    with np.load(cache) as got, np.load(bundled) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (Path(cache + ".meta").read_text()
            == Path(str(bundled) + ".meta").read_text())


def test_save_load_round_trip(port_small, tmp_path):
    path = str(tmp_path / "h.npz")
    port_small.save(path)
    assert_hierarchies_equal(TH.MeshHierarchy.load(path), port_small)


def test_build_hierarchy_from_meshes_matches_jax(small_hierarchy):
    """The pre-decimated path (nearest fine vertex for pool, barycentric
    unpool) on the small hierarchy's own coarse meshes."""
    h = small_hierarchy
    meshes = [(h.verts[l], h.faces[l]) for l in range(1, h.n_levels)]
    got = TH.build_hierarchy_from_meshes(h.verts[0], h.faces[0], meshes)
    want = JH.build_hierarchy_from_meshes(h.verts[0], h.faces[0], meshes)
    for name in ("verts", "faces", "pool_idx", "unpool_idx", "unpool_w"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
    # pool of a mesh onto its own decimation is the QEM row selection
    np.testing.assert_array_equal(got.pool_idx[0], h.pool_idx[0][:-1])


def test_compile_with_level_meshes_matches_jax(small_hierarchy):
    from semantichuman_tpu.topology import compile_topology as jax_compile

    h = small_hierarchy
    meshes = [(h.verts[l], h.faces[l]) for l in range(1, h.n_levels)]
    got = compile_topology(h.verts[0], h.faces[0], reference_vertex=0,
                           level_meshes=meshes)
    want = jax_compile(h.verts[0], h.faces[0], reference_vertex=0,
                       level_meshes=meshes)
    assert_hierarchies_equal(got, want)


@pytest.mark.parametrize("level", [0, 2])
def test_nearest_on_mesh_native_numpy_jax(small_hierarchy, level):
    """The port's AABB tree (built from native/aabb.cpp) against the JAX
    package's (face, point and barycentrics exactly), and against its
    NumPy brute force, on the fine level's vertices queried against a
    coarser level's surface, plus random points around it.  A fine vertex
    that lies on a coarse vertex or edge is nearest to several faces at
    one distance (a query may even be as near to two points), and the two
    backends may pick another of them: they agree on the distance, and
    each one's face and barycentrics give its point."""
    h = small_hierarchy
    cv, cf = h.verts[level + 1], h.faces[level + 1]
    rng = np.random.default_rng(level)
    q = np.concatenate([h.verts[level],
                        rng.normal(scale=0.3, size=(200, 3))
                        + cv.mean(axis=0)])
    native = TN.nearest_on_mesh(cv, cf, q)
    plain = TN.nearest_on_mesh(cv, cf, q, native=False)
    jax_side = JN.nearest_on_mesh(cv, cf, q)
    for a, c, name in zip(native, jax_side, ("face", "point", "bary")):
        np.testing.assert_array_equal(a, c, err_msg=f"native vs JAX {name}")
    np.testing.assert_allclose(np.linalg.norm(native[1] - q, axis=1),
                               np.linalg.norm(plain[1] - q, axis=1),
                               rtol=0, atol=1e-12)
    for face, pt, bary in (native, plain):
        tri = cv[np.asarray(cf)[face]]
        np.testing.assert_allclose(np.einsum("nk,nkd->nd", bary, tri), pt,
                                   rtol=0, atol=1e-12)
    same = native[0] == plain[0]
    assert same.mean() > 0.5
    for k in (1, 2):
        np.testing.assert_allclose(native[k][same], plain[k][same], rtol=0,
                                   atol=1e-12)


def test_nearest_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build of the AABB library raises (the JAX loader falls
    back in silence); the NumPy path needs no build."""
    TN._load_native.cache_clear()
    bad = tmp_path / "aabb.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "NATIVE_SRC", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    v = np.eye(3)
    f = np.array([[0, 1, 2]])
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            TN.nearest_on_mesh(v, f, np.zeros((1, 3)))
        face, _pt, bary = TN.nearest_on_mesh(v, f, np.zeros((1, 3)),
                                             native=False)
        assert face.tolist() == [0]
        np.testing.assert_allclose(bary, [[1 / 3, 1 / 3, 1 / 3]])
    finally:
        TN._load_native.cache_clear()


def test_closest_point_on_triangles_matches_jax():
    rng = np.random.default_rng(3)
    p, a, b, c = (rng.normal(size=(500, 3)) for _ in range(4))
    for got, want in zip(TN.closest_point_on_triangles(p, a, b, c),
                         JN.closest_point_on_triangles(p, a, b, c)):
        np.testing.assert_array_equal(got, want)


def _reference_pickle(h, path):
    """The reference's downsampling_matrices pickle of hierarchy h (the
    fixture tests/test_topology.py::test_reference_pickle_import builds)."""
    mvf = [(h.verts[l], h.faces[l]) for l in range(h.n_levels)]
    D, U = [], []
    for l in range(h.n_levels - 1):
        vc, vf = h.sizes[l + 1], h.sizes[l]
        D.append(sp.csc_matrix(
            (np.ones(vc), (np.arange(vc), h.pool_idx[l][:-1])),
            shape=(vc, vf)))
        rows = np.repeat(np.arange(vf), 3)
        cols = h.unpool_idx[l][:-1].reshape(-1)
        vals = h.unpool_w[l][:-1].reshape(-1)
        keep = vals != 0
        U.append(sp.csc_matrix((vals[keep], (rows[keep], cols[keep])),
                               shape=(vf, vc)))
    with open(path, "wb") as f:
        pickle.dump({"M_verts_faces": mvf, "A": [], "D": D, "U": U,
                     "F": [h.faces[l] for l in range(1, h.n_levels)]}, f)


def test_reference_pickle_import_matches_jax(small_hierarchy, tmp_path):
    """The reference pickle through both importers: equal hierarchies,
    cached with the same key; a second call reads the cache; a template
    that is not the pickle's level 0 is refused by both checks."""
    pkl = tmp_path / "downsampling_matrices2222.pkl"
    _reference_pickle(small_hierarchy, pkl)
    kw = dict(step_sizes=(2, 2, 1, 1, 1), dilation=(2, 2, 1, 1, 1),
              reference_vertex=0)
    got = TR.hierarchy_from_reference_pickle(
        str(pkl), cache_path=str(tmp_path / "t.npz"), **kw)
    want = JR.hierarchy_from_reference_pickle(
        str(pkl), cache_path=str(tmp_path / "j.npz"), **kw)
    assert_hierarchies_equal(got, want)
    np.testing.assert_array_equal(got.spirals[0], small_hierarchy.spirals[0])
    assert (Path(tmp_path / "t.npz.meta").read_text()
            == Path(tmp_path / "j.npz.meta").read_text())
    again = TR.hierarchy_from_reference_pickle(
        str(pkl), cache_path=str(tmp_path / "t.npz"), **kw)
    assert_hierarchies_equal(again, got)
    TR.check_template_match(got, small_hierarchy.verts[0])
    for check in (TR.check_template_match, JR.check_template_match):
        with pytest.raises(ValueError, match="level-0"):
            check(got, small_hierarchy.verts[0][:-1])
        with pytest.raises(ValueError, match="differ"):
            check(got, small_hierarchy.verts[0] + 1.0)


def test_compile_cache_key_policy(small_human, tmp_path):
    """A cache is read only where its .meta holds the compile key: one
    with another key or with none is recompiled and its key rewritten."""
    tv, tf = small_human.template_verts, small_human.template_faces
    cache = str(tmp_path / "h.npz")
    first = compile_topology(tv, tf, reference_vertex=0, cache_path=cache)
    key = compiler.topology_key(tv, tf, (2, 2, 2, 2), (2, 2, 1, 1, 1),
                                (2, 2, 1, 1, 1), 0)
    assert compiler.read_meta(cache) == key
    # a cache whose tables were tampered with is read while the key holds
    tampered = dict(np.load(cache))
    tampered["spirals_0"] = tampered["spirals_0"] * 0
    np.savez(cache, **tampered)
    assert compile_topology(tv, tf, reference_vertex=0,
                            cache_path=cache).spirals[0].max() == 0
    for meta in ("stale", None):
        if meta is None:
            os.remove(cache + ".meta")
        else:
            Path(cache + ".meta").write_text(meta)
        got = compile_topology(tv, tf, reference_vertex=0, cache_path=cache)
        assert_hierarchies_equal(got, first)
        assert compiler.read_meta(cache) == key
        np.savez(cache, **tampered)


def test_obj_io_matches_jax(tmp_path, small_human):
    """load_obj of the port and the JAX package on one file (a quad fanned
    into two triangles, colour channels ignored), and save_skl writing
    the same bytes."""
    path = tmp_path / "m.obj"
    TO.save_obj(str(path), small_human.template_verts,
                small_human.template_faces)
    with open(path, "a") as f:
        f.write("f 1/1 2/2 3/3 4/4\n")
    for got, want in zip(TO.load_obj(str(path)), JO.load_obj(str(path))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    kps = np.random.default_rng(0).normal(size=(6, 3))
    skl = [[0, 1], [1, 2, 3], [4, 5]]
    TO.save_skl(str(tmp_path / "t.obj"), kps, skl, samples_per_bone=7)
    JO.save_skl(str(tmp_path / "j.obj"), kps, skl, samples_per_bone=7)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
