"""Train and eval steps (counterpart of `semantichuman_tpu/train/step.py`).

One step of PartAE runs the three branches (main rec, interp edit, skeleton
exchange) as one encode and one decode over the concatenated segments,
every loss term, the backward and the optimizer; the neural3DMM
baseline's step (`make_baseline_train_step`) runs reconstruction and the
edge regularizer alone.  PyTorch runs them eagerly:
the kernels of the path (the spiral conv forward and its CSR-reduce
backward, the part_dist forward+gradient) launch on a CUDA tensor, and
their plain versions run on a CPU one.

Batches ({"verts" [B, V+1, 3], "measure" [B, 32], optional
"gt_face_edges" [B, 3, F], "gt_part_vols" [B, P']}) and the edit spec
(`EditSampler.sample_interp` as tensors, `to_device`) live on the model's
device before the step is called, as they do for the jitted JAX step.

`make_epoch_scan_step` is the step of the epoch path: it reads its batch,
edit spec and Adam scalars from a chunk's schedule staged on the device
(`EpochBuffers`) through a device step counter and updates the parameters
and moments in place, so one capture of it (`train/graph.py`) serves
every step of every epoch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import KPS_KEEP, NEWSKL_KEEP, SKL_KEEP
from ..ops.part_dist import PartDistTables, part_dist_sums
from ..ops.row_gather import gather_rows
from ..ops.skeleton import kps2skl, skl2kps
from ..utils.device import index_tensor
from ..utils.params import tree_leaves, tree_map, tree_unflatten
from . import losses as L
from .optim import AdamState, global_norm


@dataclass(frozen=True)
class StepFlags:
    """Loss gates and shaping knobs (from TrainConfig at a given epoch).
    The JAX package's `fused_dist` switch has no counterpart: the port's
    distance loss always takes the part_dist kernels (plain on CPU)."""
    edgereg: bool = True
    zpartreg: bool = True
    interp: bool = True
    exc: bool = True
    vol: bool = True
    editskl: bool = False
    relat: bool = True
    leafkeep: bool = True
    w_mode: str = "threshold"
    w_threshold: float = 0.8
    w_part_mode: str = "1/K"
    edgereg_w: float = 1e-2
    zpartreg_w: float = 1e-2
    vol_w: float = 1e-2
    interp_kps_w: float = 1.0
    interp_euc_w: float = 1e-2
    exc_kps_w: float = 1.0
    exc_euc_w: float = 1e-2


def flags_for_epoch(cfg_train, epoch: int) -> StepFlags:
    """A term is active once epoch > its *_epoch threshold and its weight
    is positive."""
    t = cfg_train
    return StepFlags(
        edgereg=epoch > t.edgereg_epoch and t.edgereg_w > 0,
        zpartreg=epoch > t.zpartreg_epoch and t.zpartreg_w > 0,
        interp=epoch > t.interp_epoch,
        exc=epoch > t.exc_epoch,
        vol=epoch > t.vol_epoch and t.vol_w > 0,
        editskl=t.editskl_flag, relat=t.relat_flag,
        leafkeep=t.leafkeep_flag, w_mode=t.w_mode,
        w_threshold=t.w_threshold, w_part_mode=t.w_part_mode,
        edgereg_w=t.edgereg_w, zpartreg_w=t.zpartreg_w, vol_w=t.vol_w,
        interp_kps_w=t.interp_kps_w, interp_euc_w=t.interp_euc_w,
        exc_kps_w=t.exc_kps_w, exc_euc_w=t.exc_euc_w)


def to_device(tree, device):
    """numpy leaves (a host batch or edit spec) -> tensors on `device`."""
    return tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device),
                    tree)


def _edited_kps(kps_full, skl_len_factor):
    """Scale the bone lengths by skl_len_factor and re-integrate the
    keypoints (the interp branch's editskl path)."""
    skl = kps2skl(kps_full, "ori_m")
    skl = torch.cat([skl[:, :, :3], skl[:, :, 3:] * skl_len_factor[None, :,
                                                                    None]],
                    dim=2)
    return skl2kps(skl, "ori_m")


def _ori_swapped(skl):
    keep = index_tensor(NEWSKL_KEEP, skl.device)
    out = skl.clone()
    out[:, keep, :3] = torch.flip(skl[:, keep, :3], dims=(0,))
    return out


def _m_swapped(skl):
    keep = index_tensor(SKL_KEEP, skl.device)
    out = skl.clone()
    out[:, keep, 3] = torch.flip(skl[:, keep, 3], dims=(0,))
    return out


def _exchanged_kps(kps_full, variant: str, is_ori=None):
    """Pair samples by flipping the batch and swap skeleton orientation
    ('ori'), bone length ('m') or the whole pose ('ori_m') between pairs;
    'dynamic' picks ori or m from the tensor `is_ori`."""
    if variant == "ori_m":
        return torch.flip(kps_full, dims=(0,)).index_select(
            1, index_tensor(KPS_KEEP, kps_full.device))
    skl = kps2skl(kps_full, "ori_m")
    if variant == "ori":
        skl = _ori_swapped(skl)
    elif variant == "m":
        skl = _m_swapped(skl)
    elif variant == "dynamic":
        skl = torch.where(is_ori > 0, _ori_swapped(skl), _m_swapped(skl))
    else:
        raise ValueError(f"unknown exc variant {variant!r}")
    return skl2kps(skl, "ori_m")


def make_loss_fn(model, tables: L.LossTables, flags: StepFlags,
                 exc_variant: str = "ori", sums_fn=part_dist_sums):
    """The multi-branch loss of PartAE: (params, batch, interp_batch,
    exc_batch, edit_spec) -> (loss, metrics).  `sums_fn` is the distance
    sums of the weighted distance loss: part_dist_sums (the kernels), or
    part_dist_sums_plain for the plain route."""
    jreg = tables.j_regressor
    faces = tables.faces
    kps_keep = tables.kps_keep
    ptab = PartDistTables(tables.part_indices, flags.leafkeep, flags.w_mode,
                          tables.device)

    def distance_loss(tx, rec, kps, **edit):
        return L.weighted_distance_loss(
            tx, rec, kps, ptab, w_mode=flags.w_mode,
            w_threshold=flags.w_threshold, w_part_mode=flags.w_part_mode,
            relat=flags.relat, sums_fn=sums_fn, **edit)

    def loss_fn(params, batch, interp_batch, exc_batch, edit_spec):
        metrics = {}
        tx = batch["verts"]
        segs = [tx]
        kps_full = L.regress_kps(tx[:, :-1], jreg)
        enc_kps = [gather_rows(kps_full, kps_keep)]

        if flags.interp:
            txi = interp_batch["verts"]
            kps_i = L.regress_kps(txi[:, :-1], jreg)
            if flags.editskl:
                newkps = _edited_kps(kps_i, edit_spec["skl_len_factor"])
            else:
                newkps = gather_rows(kps_i, kps_keep)
            segs.append(txi)
            enc_kps.append(newkps)
        if flags.exc:
            txe = exc_batch["verts"]
            kps_e = L.regress_kps(txe[:, :-1], jreg)
            newkps_e = _exchanged_kps(kps_e, exc_variant,
                                      edit_spec.get("exc_is_ori"))
            segs.append(txe)
            enc_kps.append(newkps_e)

        sizes = [s.shape[0] for s in segs]
        z_all, zk_all, dummy_all = model.encode(
            params, torch.cat(segs, dim=0), torch.cat(enc_kps, dim=0))
        z_segs = list(torch.split(z_all, sizes))
        zk_segs = list(torch.split(zk_all, sizes))
        dummy_segs = list(torch.split(dummy_all, sizes))
        z = z_segs[0]
        if flags.interp:
            z_segs[1] = z_segs[1] * edit_spec["a_full"][:, :, None]
        rec_all = model.decode(params, torch.cat(z_segs, dim=0),
                               torch.cat(zk_segs, dim=0),
                               torch.cat(dummy_segs, dim=0))
        rec_segs = list(torch.split(rec_all, sizes))

        rec = rec_segs[0]
        rec_l = L.rec_loss(tx, rec)
        loss = rec_l
        metrics["rec"] = rec_l

        if flags.edgereg:
            e = L.edgereg_loss(tx[:, :-1], rec[:, :-1], faces,
                               gt_edges=batch.get("gt_face_edges"))
            loss = loss + flags.edgereg_w * e
            metrics["edgereg"] = e
        if flags.zpartreg:
            zr = L.zpartreg_loss(z, batch["measure"], flags.relat)
            loss = loss + flags.zpartreg_w * zr
            metrics["zpartreg"] = zr

        if flags.interp:
            rec_i = rec_segs[1]
            if flags.interp_kps_w > 0:
                kl = L.kps_consistency_loss(rec_i[:, :-1], newkps, jreg,
                                            kps_keep)
                loss = loss + flags.interp_kps_w * kl
                metrics["interp_kps"] = kl
            if flags.interp_euc_w > 0:
                el = distance_loss(txi[:, :-1], rec_i[:, :-1], kps_i,
                                   a_full=edit_spec["a_full"],
                                   edited_mask=edit_spec["edited_mask"],
                                   n_edited=edit_spec["n_edited"])
                loss = loss + flags.interp_euc_w * el
                metrics["interp_euc"] = el

        if flags.exc:
            rec_e = rec_segs[-1]
            if flags.vol and exc_variant in ("ori", "dynamic"):
                vl = L.volume_loss(txe[:, :-1], rec_e[:, :-1], tables,
                                   gt_vols=exc_batch.get("gt_part_vols"))
                if exc_variant == "dynamic":
                    # the volume term counts on 'ori' steps only
                    vl = edit_spec["exc_is_ori"] * vl
                loss = loss + flags.vol_w * vl
                metrics["vol"] = vl
            if flags.exc_kps_w > 0:
                kl = L.kps_consistency_loss(rec_e[:, :-1], newkps_e, jreg,
                                            kps_keep)
                loss = loss + flags.exc_kps_w * kl
                metrics["exc_kps"] = kl
            if flags.exc_euc_w > 0:
                el = distance_loss(txe[:, :-1], rec_e[:, :-1], kps_e)
                loss = loss + flags.exc_euc_w * el
                metrics["exc_euc"] = el

        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn, params, *args):
    """(loss, metrics, grads): grads a tree like params, 0 for a leaf the
    loss does not reach."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model, tables: L.LossTables, optimizer,
                    flags: StepFlags, exc_variant: str = "ori",
                    sums_fn=part_dist_sums):
    """Returns step(params, opt_state, batch, interp, exc, edit_spec)
    -> (params, opt_state, metrics), metrics with the raw gradient's
    global norm `gnorm`.  New parameter tensors are returned; the inputs
    are not changed."""
    return _optimizer_step(
        make_loss_fn(model, tables, flags, exc_variant, sums_fn), optimizer)


def _optimizer_step(loss_fn, optimizer):
    """step(params, opt_state, *loss inputs) -> (params, opt_state,
    metrics): the loss's gradient, its global norm `gnorm`, one update."""
    def step(params, opt_state, *inputs):
        _, metrics, grads = value_and_grad(loss_fn, params, *inputs)
        metrics["gnorm"] = global_norm(tree_leaves(grads))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new = [p.detach() + u for p, u in zip(tree_leaves(params),
                                              tree_leaves(updates))]
        return tree_unflatten(params, new), opt_state, metrics

    return step


def make_baseline_loss_fn(model, tables: L.LossTables, flags: StepFlags):
    """The neural3DMM baseline's loss: reconstruction plus the edge
    regularizer under flags.edgereg (reference train_funcs.py:474-583):
    (params, batch) -> (loss, metrics).  The VAE trains on its mean, as in
    the JAX package (no sample, no KL term)."""
    faces = tables.faces

    def loss_fn(params, batch):
        tx = batch["verts"]
        rec, _z = model(params, tx)
        rec_l = L.rec_loss(tx, rec)
        loss = rec_l
        metrics = {"rec": rec_l}
        if flags.edgereg:
            e = L.edgereg_loss(tx[:, :-1], rec[:, :-1], faces,
                               gt_edges=batch.get("gt_face_edges"))
            loss = loss + flags.edgereg_w * e
            metrics["edgereg"] = e
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_baseline_train_step(model, tables: L.LossTables, optimizer,
                             flags: StepFlags):
    """step(params, opt_state, batch) -> (params, opt_state, metrics), the
    baseline's loss through make_train_step's gradient and Adam update."""
    return _optimizer_step(make_baseline_loss_fn(model, tables, flags),
                           optimizer)


class EpochBuffers:
    """The static device tensors of the epoch path: the parameters and
    Adam moments the step updates in place, the step counter k, the count
    of Adam updates applied in the chunk (pos: the row of `scalars` the
    next update reads) and of non-finite steps in a row (bad), a chunk's
    staged schedule (batch indices, edit specs, Adam scalars), and one row
    of metrics a step.  Every tensor keeps its storage for the Trainer's
    life, so a graph captured over them stays valid; `k_max` rows hold the
    longest chunk (train.scan_epochs epochs)."""

    N_METRICS = 16      # metric columns (a step has at most 10)

    def __init__(self, params, k_max: int, device):
        dev = torch.device(device)
        self.k_max = k_max
        self.params = tree_map(lambda p: torch.empty_like(p, device=dev),
                               params)
        self.leaves = tree_leaves(self.params)
        self.mu = [torch.empty_like(p) for p in self.leaves]
        self.nu = [torch.empty_like(p) for p in self.leaves]
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.scalars = torch.zeros((k_max, 3), dtype=torch.float32,
                                   device=dev)
        self.metrics = torch.zeros((k_max, self.N_METRICS),
                                   dtype=torch.float32, device=dev)
        self.sched: dict = {}

    def stage(self, sched: dict, scalars: np.ndarray):
        """Copy a chunk's host schedule ({name: [k, ...] array}, the
        buffers made at the first call from its shapes) and its Adam
        scalars ([k, 3], `Adam.step_scalars`) into the static buffers."""
        self.scalars[:len(scalars)].copy_(torch.from_numpy(scalars))
        for name, a in sched.items():
            a = np.ascontiguousarray(a)
            if len(a) > self.k_max:
                raise ValueError(f"a chunk of {len(a)} steps; the buffers "
                                 f"hold {self.k_max}")
            if name not in self.sched:
                self.sched[name] = torch.zeros(
                    (self.k_max,) + a.shape[1:],
                    dtype=torch.from_numpy(a).dtype, device=self.k.device)
            self.sched[name][:len(a)].copy_(torch.from_numpy(a))

    def load(self, params, opt_state: AdamState):
        """The Trainer's state in, the counters at 0."""
        torch._foreach_copy_(self.leaves, tree_leaves(params))
        torch._foreach_copy_(self.mu, list(opt_state.mu))
        torch._foreach_copy_(self.nu, list(opt_state.nu))
        self.k.zero_()
        self.pos.zero_()
        self.bad.fill_(int(opt_state.notfinite_count))

    def read(self, k: int):
        """After k steps, in one device-to-host copy: (metrics [k,
        N_METRICS] float64, Adam updates applied, non-finite steps in a
        row)."""
        host = torch.cat([self.metrics[:k].reshape(-1),
                          self.pos.float(), self.bad.float().reshape(1)]) \
            .double().cpu().numpy()
        return (host[:-2].reshape(k, self.N_METRICS), int(host[-2]),
                int(host[-1]))

    def state_out(self, opt_state: AdamState, applied: int, bad: int):
        """Copies of the parameters and the Adam state (the buffers stay
        the graph's)."""
        params = tree_unflatten(self.params, [p.clone() for p in self.leaves])
        return params, replace(opt_state, count=opt_state.count + applied,
                               mu=[m.clone() for m in self.mu],
                               nu=[n.clone() for n in self.nu],
                               notfinite_count=bad)


def make_epoch_scan_step(model, tables: L.LossTables, optimizer,
                         flags: StepFlags, exc_variant: str, batch_fn,
                         sums_fn=part_dist_sums):
    """One step of the epoch path (the counterpart of the JAX package's
    `make_epoch_scan_step`, whose lax.scan runs it over the chunk):
    step(buf: EpochBuffers) reads row k of the staged schedule ("idx_tr",
    "idx_in", "idx_ex" [K, B] int64, "spec:<name>" [K, ...]) through the
    device counter buf.k, runs the loss, its gradient and
    `Adam.update_` with row buf.pos of buf.scalars, writes the metrics
    (`step.metric_names`, the loss terms and gnorm) into row k of
    buf.metrics, and adds 1 to k.  It reads no host value, so it can be
    captured as a CUDA graph.  exc_variant 'dynamic' reads each step's
    'ori'/'m' draw from spec "exc_is_ori".  batch_fn(idx [B]) -> a batch
    dict (`DeviceDataSource.batch_fn`)."""
    loss_fn = make_loss_fn(model, tables, flags, exc_variant, sums_fn)
    names: list = []

    def step(buf: EpochBuffers):
        k, sched = buf.k, buf.sched

        def row(name):
            return sched[name].index_select(0, k)[0]

        spec = {name[5:]: row(name) for name in sched
                if name.startswith("spec:")}
        _, metrics, grads = value_and_grad(
            loss_fn, buf.params, batch_fn(row("idx_tr")),
            batch_fn(row("idx_in")), batch_fn(row("idx_ex")), spec)
        grads = tree_leaves(grads)
        metrics["gnorm"] = global_norm(grads)
        keep = optimizer.update_(grads, buf.leaves, buf.mu, buf.nu,
                                 buf.scalars.index_select(0, buf.pos)[0],
                                 buf.bad)
        buf.pos.add_(1 if keep is None else keep.long())
        if not names:
            names.extend(metrics)
        vals = torch.stack([metrics[n].float().reshape(()) for n in names])
        buf.metrics.narrow(1, 0, len(names)).index_copy_(0, k, vals[None])
        k.add_(1)

    step.metric_names = names
    return step


def make_eval_step(model, tables: L.LossTables, mm_constant: float = 1000.0):
    """Per-sample eval metrics: mean L1 and mean per-vertex Euclidean error
    in mm, dummy row excluded.  The baseline (a model without a keypoint
    encoder) has no z_kps: [B, 0, 0]."""
    jreg = tables.j_regressor
    kps_keep = tables.kps_keep
    part_model = hasattr(model, "kps_encode")

    @torch.no_grad()
    def step(params, batch):
        tx = batch["verts"]
        if part_model:
            kps = L.regress_kps(tx[:, :-1], jreg)
            rec, z, z_kps = model(params, tx, gather_rows(kps, kps_keep))
        else:
            rec, z = model(params, tx)
            z_kps = tx.new_zeros((tx.shape[0], 0, 0))
        x, xr = tx[:, :-1], rec[:, :-1]
        l1 = torch.mean(torch.abs(xr - x), dim=(1, 2))
        l2mm = torch.mean(torch.sqrt(torch.sum(
            ((xr - x) * mm_constant) ** 2, dim=2)), dim=1)
        return {"rec": rec, "z": z, "z_kps": z_kps, "l1": l1, "l2_mm": l2mm}

    return step
