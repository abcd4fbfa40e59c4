"""Train and eval steps (counterpart of `semantichuman_tpu/train/step.py`).

One step runs the three branches (main rec, interp edit, skeleton
exchange) as one encode and one decode over the concatenated segments,
every loss term, the backward and the optimizer.  PyTorch runs it eagerly:
the kernels of the path (the spiral conv forward and its CSR-reduce
backward, the part_dist forward+gradient) launch on a CUDA tensor, and
their plain versions run on a CPU one.

Batches ({"verts" [B, V+1, 3], "measure" [B, 32], optional
"gt_face_edges" [B, 3, F], "gt_part_vols" [B, P']}) and the edit spec
(`EditSampler.sample_interp` as tensors, `to_device`) live on the model's
device before the step is called, as they do for the jitted JAX step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import KPS_KEEP, NEWSKL_KEEP, SKL_KEEP
from ..ops.part_dist import PartDistTables, part_dist_sums
from ..ops.row_gather import gather_rows
from ..ops.skeleton import kps2skl, skl2kps
from ..utils.device import index_tensor
from ..utils.params import tree_leaves, tree_map, tree_unflatten
from . import losses as L
from .optim import global_norm


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
    loss_fn = make_loss_fn(model, tables, flags, exc_variant, sums_fn)

    def step(params, opt_state, batch, interp_batch, exc_batch, edit_spec):
        _, metrics, grads = value_and_grad(loss_fn, params, batch,
                                           interp_batch, exc_batch,
                                           edit_spec)
        metrics["gnorm"] = global_norm(tree_leaves(grads))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new = [p.detach() + u for p, u in zip(tree_leaves(params),
                                              tree_leaves(updates))]
        return tree_unflatten(params, new), opt_state, metrics

    return step


def make_eval_step(model, tables: L.LossTables, mm_constant: float = 1000.0):
    """Per-sample eval metrics: mean L1 and mean per-vertex Euclidean error
    in mm, dummy row excluded."""
    jreg = tables.j_regressor
    kps_keep = tables.kps_keep

    @torch.no_grad()
    def step(params, batch):
        tx = batch["verts"]
        kps = L.regress_kps(tx[:, :-1], jreg)
        rec, z, z_kps = model(params, tx, gather_rows(kps, kps_keep))
        x, xr = tx[:, :-1], rec[:, :-1]
        l1 = torch.mean(torch.abs(xr - x), dim=(1, 2))
        l2mm = torch.mean(torch.sqrt(torch.sum(
            ((xr - x) * mm_constant) ** 2, dim=2)), dim=1)
        return {"rec": rec, "z": z, "z_kps": z_kps, "l1": l1, "l2_mm": l2mm}

    return step
