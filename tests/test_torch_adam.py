"""The optimizer's leaf table (`ops/adam.py:leaf_plan`) and the CPU's
plain chain (`train/optim.py`).

The kernels themselves run only on the card
(`tests/test_torch_kernels_cuda.py`); here the plan that cuts every leaf
into the blocks' chunks is held to covering each entry once, and the CPU
path to the chain of PyTorch calls, with no kernel reached.
"""

import numpy as np
import pytest
import torch

from semantichuman_torch.ops import adam as A
from semantichuman_torch.ops import launches
from semantichuman_torch.train import optim as O
from semantichuman_torch.utils.params import tree_leaves

# the leaves of the full-width PartAE and neural3DMM (tree_leaves order,
# `test_leaf_sizes_are_the_models`)
PARTAE_SIZES = (720, 16, 5632, 32, 16384, 64, 65536, 128, 65536, 64, 16384,
                32, 11264, 32, 7680, 16, 720, 3, 1340416, 136, 2680832,
                167552, 1632, 136)
N3DMM_SIZES = (720, 16, 5632, 32, 16384, 64, 65536, 128, 65536, 64, 16384,
               32, 11264, 32, 7680, 16, 720, 3, 14155776, 256, 14155776,
               55296)
RAGGED = (0, 1, 3, 4, 5, 4095, 4096, 4097, 0, 12289)
LONG = tuple((i * 7919) % 20000 for i in range(70))


def _plan_chunks(plan) -> list:
    """(leaf, first entry, end) of every chunk in the order of the partial
    sums, each found as the kernels find it (`csrc/adam.cu:leaf_of`: the
    last leaf of the launch whose first chunk is at or before the
    block's)."""
    out = []
    for ln in plan.launches:
        first = ln.first
        for c in range(int(first[-1])):
            leaf = 0
            while leaf + 1 < ln.hi - ln.lo and first[leaf + 1] <= c:
                leaf += 1
            lo = (c - int(first[leaf])) * plan.chunk
            n = plan.sizes[ln.lo + leaf]
            out.append((ln.lo + leaf, lo, min(lo + plan.chunk, n)))
    return out


def _chunks_by_leaf(plan):
    by_leaf = {}
    for leaf, lo, hi in _plan_chunks(plan):
        by_leaf.setdefault(leaf, []).append((lo, hi))
    return by_leaf


@pytest.mark.parametrize("sizes", [PARTAE_SIZES, N3DMM_SIZES, RAGGED, LONG],
                         ids=["partae", "n3dmm", "ragged", "long"])
def test_leaf_plan_covers_every_entry_once(sizes):
    """Walked as the kernels walk it, the plan's chunks tile each leaf from
    0 to its size, in order, with no gap and no overlap, and an empty leaf
    has none; the partial sums have one row a chunk."""
    plan = A.leaf_plan(sizes)
    by_leaf = _chunks_by_leaf(plan)
    for leaf, n in enumerate(sizes):
        spans = by_leaf.get(leaf, [])
        assert [lo for lo, _ in spans] == list(range(0, n, A.CHUNK))
        assert [hi for _, hi in spans] == [min(lo + A.CHUNK, n)
                                          for lo, _ in spans]
    assert len(_plan_chunks(plan)) == plan.n_chunks


@pytest.mark.parametrize("sizes", [PARTAE_SIZES, N3DMM_SIZES, RAGGED, LONG],
                         ids=["partae", "n3dmm", "ragged", "long"])
def test_leaf_plan_is_balanced_across_leaf_sizes(sizes):
    """No chunk holds more than CHUNK entries and only a leaf's last chunk
    fewer, so a 14 M-entry leaf spreads over many blocks and a 3-entry one
    takes one: each leaf gets ceil(n / CHUNK) chunks."""
    plan = A.leaf_plan(sizes)
    by_leaf = _chunks_by_leaf(plan)
    for leaf, n in enumerate(sizes):
        spans = by_leaf.get(leaf, [])
        assert len(spans) == -(-n // A.CHUNK)
        assert all(hi - lo == A.CHUNK for lo, hi in spans[:-1])
        assert all(0 < hi - lo <= A.CHUNK for lo, hi in spans)


def test_leaf_plan_splits_a_long_leaf_list():
    """70 leaves take three launches of at most MAX_LEAVES, in order; each
    launch's partial sums start where the last one's ended."""
    plan = A.leaf_plan(LONG)
    assert [(ln.lo, ln.hi) for ln in plan.launches] == [(0, 32), (32, 64),
                                                        (64, 70)]
    base = 0
    for ln in plan.launches:
        assert ln.base == base
        assert ln.first.dtype == np.int32 and ln.first[0] == 0
        assert len(ln.first) == ln.hi - ln.lo + 1
        base += int(ln.first[-1])
    assert base == plan.n_chunks
    assert len(A.leaf_plan(PARTAE_SIZES).launches) == 1
    assert len(A.leaf_plan(N3DMM_SIZES).launches) == 1


def test_vector_mask_reads_every_pointer_of_a_leaf():
    """Bit i only where every pointer of leaf i is 16-byte aligned; a null
    pointer (the in-place update's) does not count against it."""
    ptrs = np.array([[16, 32, 48], [0, 8, 64], [4096, 4096, 0]],
                    dtype=np.uint64)
    assert A._vec(ptrs) == 0b101


def test_leaf_sizes_are_the_models():
    """The sizes above are the full-width models' leaves."""
    from semantichuman_torch.config import Config
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.utils.params import tree_leaves

    hier = MeshHierarchy.load("assets/topology_synth_full_2222.npz")
    part_dict = SyntheticHuman().part_dict
    for model_type, extra, want in (("multiz+partkps", {}, PARTAE_SIZES),
                                    ("neural3DMM", {"nz": 256}, N3DMM_SIZES)):
        cfg = Config.from_dict({"model": {"model_type": model_type, **extra}})
        model = build_model(cfg.model, hier, part_dict, device="cpu")
        assert tuple(t.numel() for t in tree_leaves(model.init(0))) == want


def _state(sizes, seed, bad_entry=None):
    rng = np.random.default_rng(seed)

    def leaves(scale, positive=False):
        out = [rng.standard_normal(n).astype(np.float32) * scale
               for n in sizes]
        return [torch.from_numpy(np.abs(a) if positive else a) for a in out]

    grads = leaves(1.0)
    if bad_entry is not None:
        grads[1][0] = bad_entry
    return grads, leaves(0.5), leaves(0.1), leaves(0.01, positive=True)


def _no_kernels(monkeypatch):
    """Every kernel wrapper of ops/adam.py replaced by one that raises."""
    for name in ("adam_sumsq", "adam_norm", "adam_update", "grad_norm"):
        def refuse(*_a, _name=name, **_k):
            raise AssertionError(f"{_name} was called on the CPU")

        refuse.launches = 0
        monkeypatch.setattr(A, name, refuse)


@pytest.mark.parametrize("clip,wd,b2", [(0.0, 5e-5, 0.999), (0.5, 5e-5, 0.95),
                                        (1e3, 0.0, 0.95)],
                         ids=["no_clip", "clip_engaged", "clip_idle"])
def test_cpu_update_takes_the_plain_chain(monkeypatch, clip, wd, b2):
    """On the CPU `update` and `update_` reach no kernel wrapper and compute
    `_moments`, the chain of PyTorch calls: update's updates, moments and
    update_'s parameters bit for bit, update_ reading the norm from its
    scalars."""
    before = launches.read()
    _no_kernels(monkeypatch)
    opt = O.Adam(lambda step: 1e-3 * 0.99 ** step, wd, b2=b2, grad_clip=clip)
    grads, params, mu, nu = _state((40, 7, 130), 3)
    scalars = torch.from_numpy(opt.step_scalars(4, 1)[0])
    stats = O.global_norm(grads)
    ref_mu, ref_nu, ref_u = opt._moments(grads, params, mu, nu, scalars,
                                         stats)
    state = O.AdamState(count=4, mu=[m.clone() for m in mu],
                        nu=[n.clone() for n in nu])
    upd, st = opt.update(grads, state, params)
    assert all(torch.equal(a, b) for a, b in zip(upd, ref_u))
    assert all(torch.equal(a, b) for a, b in zip(st.mu + st.nu,
                                                 ref_mu + ref_nu))
    p2, m2, n2 = ([t.clone() for t in ts] for ts in (params, mu, nu))
    assert opt.update_(grads, p2, m2, n2, torch.cat((scalars, stats))) \
        is None
    assert all(torch.equal(a, b + u) for a, b, u in zip(p2, params, ref_u))
    assert all(torch.equal(a, b) for a, b in zip(m2 + n2, ref_mu + ref_nu))
    monkeypatch.undo()
    assert launches.diff(launches.read(), before)["adam_update"] == 0


def test_cpu_skip_rule_and_norm_take_the_plain_chain(monkeypatch):
    """skip_nonfinite on the CPU: `global_norm` is the plain sum and
    torch.isfinite's flag, and a NaN step is skipped by both updates (bad
    counts it, parameters + 0, moments kept), with no kernel reached."""
    _no_kernels(monkeypatch)
    opt = O.Adam(lambda step: 1e-3, 5e-5, skip_nonfinite=2)
    grads, params, mu, nu = _state((40, 7), 5)
    stats = O.global_norm(grads)
    assert torch.equal(stats, O.global_norm_plain(grads))
    exact = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    assert stats.shape == (2,) and float(stats[1]) == 0.0
    assert abs(float(stats[0]) - exact) <= 1e-6 * exact
    grads, params, mu, nu = _state((40, 7), 5, bad_entry=float("nan"))
    stats = O.global_norm(grads)
    assert float(stats[1]) == 1.0
    scalars = torch.from_numpy(opt.step_scalars(0, 1)[0])
    bad = torch.zeros((), dtype=torch.int64)
    p2, m2, n2 = ([t.clone() for t in ts] for ts in (params, mu, nu))
    keep = opt.update_(grads, p2, m2, n2, torch.cat((scalars, stats)), bad)
    assert not bool(keep) and int(bad) == 1
    assert all(torch.equal(a, b) for a, b in zip(p2 + m2 + n2,
                                                 params + mu + nu))
    state = O.AdamState(count=0, mu=mu, nu=nu)
    upd, st = opt.update(grads, state, params)
    assert (st.count, st.notfinite_count) == (0, 1)
    assert all(not bool(u.any()) for u in upd)


def _tiny_step():
    params = {"w": torch.ones(5), "b": torch.zeros(2)}

    def loss_fn(p, x):
        loss = (p["w"] * x).sum() ** 2 + p["b"].sum()
        return loss, {"loss": loss}

    return params, loss_fn


def _epoch_buffers(S, opt, params):
    buf = S.EpochBuffers(params, 2, "cpu")
    buf.load(params, opt.init(params))
    buf.stage({}, opt.step_scalars(0, 2))
    return buf


def test_steps_compute_the_norm_once_for_metric_and_update(monkeypatch):
    """The epoch step computes the norm once, through `step.global_norm`
    (the name tools/dp_fit.py patches), and hands it to `update_` as the
    last two of its scalars, so the `gnorm` metric and the clip read one
    result; the loop step's metric is `step.global_norm`'s too."""
    from semantichuman_torch.train import step as S

    seen, got = [], []
    norm = S.global_norm

    def recording(leaves):
        seen.append(norm(leaves))
        return seen[-1]

    monkeypatch.setattr(S, "global_norm", recording)
    opt = O.Adam(lambda step: 1e-3, 5e-5, grad_clip=1.0)
    upd_ = opt.update_

    def update_(grads, params, mu, nu, scalars, bad=None):
        got.append(scalars)
        return upd_(grads, params, mu, nu, scalars, bad)

    monkeypatch.setattr(opt, "update_", update_)
    params, loss_fn = _tiny_step()
    step = S._optimizer_step(loss_fn, opt)
    _p, _st, metrics = step(params, opt.init(params), torch.arange(5.0))
    assert len(seen) == 1 and torch.equal(metrics["gnorm"], seen[-1][0])

    buf = _epoch_buffers(S, opt, params)
    S._epoch_step(loss_fn, opt,
                  lambda _row, _sched: (torch.arange(5.0),))(buf)
    assert len(seen) == 2 and len(got) == 1
    assert torch.equal(got[-1][3:], seen[-1])
    assert torch.equal(got[-1][:3], buf.scalars[0])
    assert float(buf.metrics[0, 1]) == float(seen[-1][0])


@pytest.mark.parametrize("epoch_path", [False, True], ids=["loop", "epoch"])
def test_steps_call_the_optimizer_positionally(monkeypatch, epoch_path):
    """Both steps call `update` as (grads, state, params) and `update_` as
    (grads, params, mu, nu, scalars, bad), with no keyword, so stand-ins of
    that shape (a frozen optimizer) take the step's place: the parameters
    stay as they were."""
    from semantichuman_torch.train import step as S

    def frozen_(self, grads, params, mu, nu, scalars, bad=None):
        return None

    monkeypatch.setattr(O.Adam, "update_", frozen_)
    monkeypatch.setattr(O.Adam, "update", lambda self, g, s, p: (
        {k: torch.zeros_like(v) for k, v in g.items()}, s))
    opt = O.Adam(lambda step: 1e-3, 5e-5, grad_clip=1.0, skip_nonfinite=2)
    params, loss_fn = _tiny_step()
    if epoch_path:
        buf = _epoch_buffers(S, opt, params)
        S._epoch_step(loss_fn, opt,
                      lambda _row, _sched: (torch.arange(5.0),))(buf)
        new = buf.leaves
    else:
        step = S._optimizer_step(loss_fn, opt)
        new, _st, _m = step(params, opt.init(params), torch.arange(5.0))
        new = tree_leaves(new)
    assert all(torch.equal(a, b) for a, b in zip(new, tree_leaves(params)))
