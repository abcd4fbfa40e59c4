"""The port's banded gather (rows 5 and 6 of the kernel table) and row
gather (row 7), through their plain versions on the CPU, against the JAX
package: `diag_banded_gather` run in Pallas interpret mode, and
`jnp.take`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.ops import banding as TB
from semantichuman_torch.ops import banded_gather as BG
from semantichuman_torch.ops import row_gather as RG
from semantichuman_tpu.ops import banding as JB
from semantichuman_tpu.ops.pallas import banded_gather_pallas as bgp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(bgp, "_INTERPRET", True)


def _synth_table(n, s, spread, seed=0, far_frac=0.02):
    """Local-ish index table with dummy pads and a few far entries (the
    out-of-band fix-up path), as tests/test_banded_pallas.py builds it."""
    rng = np.random.default_rng(seed)
    dummy = n - 1
    tbl = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread,
                                                       (n, s)), 0, n - 1)
    tbl[rng.random((n, s)) < 0.3] = dummy
    far = rng.random((n, s)) < far_frac
    tbl[far] = rng.integers(0, n, far.sum())
    return tbl.astype(np.int32), dummy


def _table(tbl, R, K, dummy, weights=None):
    """The same DiagBandSpec in both packages (held equal in
    test_torch_banding.py) and the port's BandTable around it."""
    jspec = JB.build_diag_spec(tbl, R, K, dummy=dummy)
    tspec = TB.build_diag_spec(tbl, R, K, dummy=dummy)
    band = TB.BandSpec(starts=(), fix_pos=tspec.fix_pos,
                       fix_src=tspec.fix_src, R=R, W=K * R, oob_frac=0.0,
                       diag=tspec)
    return jspec, BG.BandTable.build(band, "cpu", weights)


def _jax_grad(fn, x, ct):
    return np.array(jax.grad(lambda v: jnp.sum(fn(v) * ct))(x))


def _torch_grad(fn, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    (fn(xt) * torch.tensor(ct)).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("n,s,R,K", [(600, 5, 128, 4), (600, 15, 128, 4),
                                     (300, 3, 64, 3)])
def test_unweighted_matches_pallas(n, s, R, K):
    """Row 5 exact; row 6 (the VJP) to rtol/atol 1e-5 with the dummy row
    zeroed (its cotangent is discarded by the producing op)."""
    tbl, dummy = _synth_table(n, s, 150)
    jspec, table = _table(tbl, R, K, dummy)
    rng = np.random.default_rng(1)
    xp = rng.normal(size=(n, 24)).astype(np.float32)
    xp[dummy] = 0.0
    want = np.asarray(bgp.diag_banded_gather(jnp.asarray(xp), None, jspec))
    got = BG.banded_gather_fwd(torch.tensor(xp), table).numpy()
    np.testing.assert_array_equal(got, want)
    ct = rng.normal(size=(n * s, 24)).astype(np.float32)
    dk = _jax_grad(lambda v: bgp.diag_banded_gather(v, None, jspec),
                   jnp.asarray(xp), jnp.asarray(ct))
    dt = _torch_grad(lambda v: BG.BandedGatherFn.apply(v, table), xp, ct)
    dk[dummy] = 0
    dt[dummy] = 0
    np.testing.assert_allclose(dt, dk, rtol=1e-5, atol=1e-5)


def test_weighted_matches_pallas():
    """The weighted form (unpool's barycentric taps): values to rtol 1e-6
    (one product per row either way), the VJP to 1e-5."""
    n, s, R, K = 300, 3, 64, 3
    rng = np.random.default_rng(3)
    dummy = n - 1
    tbl = np.clip(np.arange(n)[:, None] // 2
                  + rng.integers(-30, 30, (n, s)), 0, n - 1).astype(np.int32)
    w = rng.random((n, s)).astype(np.float32)
    jspec, table = _table(tbl, R, K, dummy, weights=w.reshape(-1))
    w_pad = np.zeros((jspec.nblk * R, s), np.float32)
    w_pad[:n] = w
    xp = rng.normal(size=(n, 16)).astype(np.float32)
    xp[dummy] = 0
    jw = w_pad.reshape(jspec.nblk, R * s)
    want = np.asarray(bgp.diag_banded_gather(jnp.asarray(xp), jw, jspec))
    got = BG.banded_gather_fwd(torch.tensor(xp), table).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    ct = rng.normal(size=(n * s, 16)).astype(np.float32)
    dk = _jax_grad(lambda v: bgp.diag_banded_gather(v, jw, jspec),
                   jnp.asarray(xp), jnp.asarray(ct))
    dt = _torch_grad(lambda v: BG.BandedGatherFn.apply(v, table), xp, ct)
    dk[dummy] = 0
    dt[dummy] = 0
    np.testing.assert_allclose(dt, dk, rtol=1e-5, atol=1e-5)


def test_bfloat16_forward_is_a_copy():
    """Unweighted, the forward copies rows: bf16 in, the same bf16 out."""
    tbl, dummy = _synth_table(300, 7, 60, seed=2)
    _, table = _table(tbl, 64, 3, dummy)
    x = torch.randn(300, 10, generator=torch.Generator().manual_seed(0))
    x[dummy] = 0
    got = BG.banded_gather_fwd(x.bfloat16(), table)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               BG.banded_gather_fwd(x.bfloat16().float(),
                                                    table), rtol=0, atol=0)


def test_backward_table_is_the_transpose():
    """The backward's CSR table lists, per source row, exactly the in-band
    output rows that read it, in ascending order; fix-ups cover the rest
    of the real entries."""
    tbl, dummy = _synth_table(600, 9, 150, seed=4)
    _, table = _table(tbl, 128, 4, dummy)
    offs = table.bwd.offs.numpy()
    cols = table.bwd.cols.numpy()
    src, inband = BG._sources(table)
    src, inband = src.numpy(), inband.numpy()
    for u in range(table.n_src):
        run = cols[offs[u]:offs[u + 1]]
        assert np.all(np.diff(run) > 0)
        np.testing.assert_array_equal(run, np.nonzero(inband
                                                      & (src == u))[0])
    flat = tbl.reshape(-1)
    np.testing.assert_array_equal(src[inband], flat[inband])
    n_fix = int((table.diag.fix_src != dummy).sum())
    assert n_fix + int(inband[flat != dummy].sum()) == int(
        (flat != dummy).sum())


def test_bad_spec_raises():
    tbl, dummy = _synth_table(300, 3, 30, seed=5)
    spec = TB.build_diag_spec(tbl, 64, 3, dummy=dummy)
    bad = TB.BandSpec(starts=(), fix_pos=spec.fix_pos, fix_src=spec.fix_src,
                      R=64, W=192, oob_frac=0.0,
                      diag=TB.DiagBandSpec(**{**vars(spec),
                                              "n_src": dummy - 40}))
    with pytest.raises(ValueError, match="outside"):
        BG.BandTable.build(bad, "cpu")
    with pytest.raises(ValueError, match="weights"):
        BG.BandTable.build(TB.BandSpec(starts=(), fix_pos=spec.fix_pos,
                                       fix_src=spec.fix_src, R=64, W=192,
                                       oob_frac=0.0, diag=spec), "cpu",
                           np.ones(7, np.float32))


@pytest.mark.parametrize("n_src,d,n_out", [(300, 24, 64), (6893, 36, 2368),
                                           (50, 3, 7)])
def test_row_gather_matches_take(n_src, d, n_out):
    """Row 7: exact against jnp.take; its gradient (the CSR reduce over the
    inverse index, repeated indices summed) against jax.grad of the take."""
    rng = np.random.default_rng(n_src)
    x = rng.normal(size=(n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, n_out).astype(np.int32)
    idx[:3] = idx[3]                          # repeated rows
    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0))
    table = RG.GatherTable.build(idx, n_src, "cpu")
    got = RG.row_gather(torch.tensor(x), table.idx).numpy()
    np.testing.assert_array_equal(got, want)
    ct = rng.normal(size=(n_out, d)).astype(np.float32)
    dk = _jax_grad(lambda v: jnp.take(v, jnp.asarray(idx), axis=0),
                   jnp.asarray(x), jnp.asarray(ct))
    dt = _torch_grad(lambda v: RG.RowGatherFn.apply(v, table), x, ct)
    np.testing.assert_allclose(dt, dk, rtol=1e-6, atol=1e-6)


def test_row_gather_table_checks():
    with pytest.raises(ValueError, match="outside"):
        RG.GatherTable.build(np.array([0, 5]), 5, "cpu")
    t = torch.zeros(2, 2)
    assert RG.copy_unit(16, t) == 16
    assert RG.copy_unit(6, t) == 2
    with pytest.raises(ValueError, match="copy unit"):
        RG.copy_unit(3, t)
