"""The plain reference of the training recipe: the data schedule, the loss
stack, the gradient and the Adam update of the first steps of a run, in
float32 PyTorch, from the run's seed and the inputs the benchmark made.

It works out again everything the program derives: the normalised
batches, the seeded batch order and the interp/exchange cycle, the edit
draws, the exchanged skeletons, the ground-truth edge lengths and part
volumes, the lr schedule and Adam's bias corrections.  The recipe's own
definitions (the reference repository's train_funcs.py and the paper):

  rec        mean |rec - x|
  edgereg    mean |edge_rec / (edge_gt + 1e-5) - 1| over the face edges
  zpartreg   mean |‖z_p‖ / girth_p - 1| over the 12 non-leaf parts
  kps        mean |J rec - target keypoints| of an edited decode
  distance   per part, the masked mean of |w (d_rec / d_gt) - w| over the
             part's vertex pairs, w the pair's angle to the part's bone
             (acos of |cos| scaled to [0, 1], cut to 0 below the
             threshold, 1 on leaf parts), summed over parts with 1/17
  volume     mean | |vol_rec / vol_gt| - 1 | over the non-leaf parts
  Adam       coupled L2 (decay added to the clipped gradient), b1 0.9,
             eps 1e-8, lr per epoch (exponential or cosine, warm-up)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import (LEAF_PART_INDICES, NEWSKL_KEEP,
                        NEWSKL_LIST, NOLEAF_IN_MEASURE, NOLEAF_PART_INDICES,
                        SKL_KEEP, SKL_LIST, bone_endpoint_arrays,
                        skl_path_matrix)
from .model import keep_kps, regress

ANCHOR_STRIDE = 1 << 16


# --- the schedule -------------------------------------------------------------

def batch_order(n: int, batch: int, seed: int, epoch: int) -> list:
    """The shuffled, drop-last batches of one pass over n samples."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return [order[s:s + batch] for s in range(0, n // batch * batch, batch)]


def interp_cycle(n: int, batch: int, seed: int, epoch: int):
    """The endless interp/exchange draw of a train epoch: passes from the
    epoch's anchor on."""
    e = epoch * ANCHOR_STRIDE
    while True:
        yield from batch_order(n, batch, seed + 101, e)
        e += 1


def edit_draws(seed: int, epoch: int, factor=(0.4, 0.8)):
    """Per step: (exchange variant, the 'equal' edit's scale), drawn in
    that order from the epoch's generator."""
    rng = np.random.default_rng((seed + 1) * (1 << 24) + epoch)
    while True:
        variant = "ori" if rng.random(1)[0] > 0.5 else "m"
        fac = float(rng.random(1)[0]) * factor[0] + factor[1]
        yield variant, fac


def lr_at(step: int, tr: dict, steps_per_epoch: int) -> float:
    epoch = step // max(steps_per_epoch, 1)
    if tr["lr_schedule"] == "cosine":
        frac = min(max(epoch / max(tr["n_epochs"], 1), 0.0), 1.0)
        lr = tr["lr"] * 0.5 * (1.0 + math.cos(math.pi * frac))
    else:
        lr = tr["lr"] * tr["lr_decay"] ** epoch
    if tr["lr_warmup_epochs"]:
        lr *= min((step + 1.0) / (tr["lr_warmup_epochs"] * steps_per_epoch),
                  1.0)
    return lr


def adam(params, grads, state, step: int, tr: dict, steps_per_epoch: int):
    """One Adam step on lists of tensors: -> (new params, new state, the
    gradient Adam took in, after the clip and the coupled decay)."""
    if tr["grad_clip"] > 0:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= tr["grad_clip"]:
            grads = [g / norm * tr["grad_clip"] for g in grads]
    grads = [g + tr["weight_decay"] * p for g, p in zip(grads, params)]
    b1, b2 = 0.9, tr["adam_b2"]
    mu = [b1 * m + (1 - b1) * g for m, g in zip(state["mu"], grads)]
    nu = [b2 * v + (1 - b2) * g * g for v, g in zip(state["nu"], grads)]
    lr = np.float32(lr_at(step, tr, steps_per_epoch))
    bc1, bc2 = np.float32(1 - b1 ** (step + 1)), np.float32(1 - b2 ** (step + 1))
    new = [p - float(lr) * (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + 1e-8)
           for p, m, v in zip(params, mu, nu)]
    return new, {"mu": mu, "nu": nu}, grads


# --- the loss stack -----------------------------------------------------------

class LossTables:
    def __init__(self, faces, part_dict, device):
        faces = np.asarray(faces, np.int64)
        self.faces = torch.as_tensor(faces, device=device)
        n_v = int(faces.max()) + 1
        part_of = np.full(n_v, -1)
        self.parts = []
        for k, idx in enumerate(part_dict.values()):
            part_of[np.asarray(idx)] = k
            self.parts.append(torch.as_tensor(np.asarray(idx), device=device))
        fp = part_of[faces]
        uniform = (fp[:, 0] == fp[:, 1]) & (fp[:, 0] == fp[:, 2])
        self.face_mask = torch.as_tensor(np.stack(
            [uniform & (fp[:, 0] == p) for p in NOLEAF_PART_INDICES],
            axis=1).astype(np.float32), device=device)
        a, b1, b2 = bone_endpoint_arrays(SKL_LIST)
        self.bones = [torch.as_tensor(x, dtype=torch.long, device=device)
                      for x in (a, b1, b2)]
        a, b1, _ = bone_endpoint_arrays(NEWSKL_LIST)
        self.skl = [torch.as_tensor(x, dtype=torch.long, device=device)
                    for x in (a, b1)]
        self.path = torch.as_tensor(skl_path_matrix(NEWSKL_LIST),
                                    device=device)


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def edge_lengths(v, faces):
    a, b, c = v[:, faces[:, 0]], v[:, faces[:, 1]], v[:, faces[:, 2]]
    n = torch.linalg.vector_norm
    return torch.stack([n(a - b, dim=-1), n(b - c, dim=-1),
                        n(a - c, dim=-1)], dim=1)


def part_volumes(v, faces, mask):
    a, b, c = v[:, faces[:, 0]], v[:, faces[:, 1]], v[:, faces[:, 2]]
    vol = torch.sum(torch.linalg.cross(a, b, dim=-1) * c, dim=-1)
    return vol @ mask


def distance_loss(tx, rec, kps_full, tab: LossTables, a_full=None,
                  w_threshold: float = 0.8):
    """The weighted intra-part distance loss (w_mode threshold, relat,
    leafkeep, part weight 1/17)."""
    a, b1, b2 = tab.bones
    bones = kps_full[:, a] - 0.5 * (kps_full[:, b1] + kps_full[:, b2])
    total = 0.0
    for p, idx in enumerate(tab.parts):
        vp, rp = tx[:, idx], rec[:, idx]
        n = vp.shape[1]
        with torch.no_grad():
            diff = vp[:, :, None] - vp[:, None, :]
            de0 = torch.linalg.vector_norm(diff, dim=-1)
            if p in LEAF_PART_INDICES:
                w = torch.ones_like(de0)
            else:
                bone = bones[:, p]
                dot = torch.einsum("bjkd,bd->bjk", diff, bone)
                denom = de0 * torch.linalg.vector_norm(bone, dim=-1)[:, None,
                                                                      None]
                cos = torch.where(denom > 0,
                                  dot.abs() / torch.where(denom > 0, denom,
                                                          1.0), 1.0)
                w = torch.acos(torch.clamp(cos, 0.0, 1.0)) * (2.0 / math.pi)
                w = torch.where(w < w_threshold, 0.0, w)
            w = w * (1.0 - torch.eye(n, device=w.device))[None]
            scale = 1.0 if a_full is None else a_full[:, p, None, None]
            de = de0 * scale
            mask = (w * de) != 0
        d2 = ((rp[:, :, None] - rp[:, None, :]) ** 2).sum(-1)
        live = mask & (d2 > 0)
        d_r = torch.where(live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0)
        term = (w * (d_r / torch.where(mask, de, 1.0)) - w).abs()
        term = torch.where(mask, term, 0.0)
        total = total + term.sum() / torch.clamp(mask.float().sum(), min=1.0) \
            / len(tab.parts)
    return total


def skeleton(kps_full, tab: LossTables):
    a, b = tab.skl
    vec = kps_full[:, a] - kps_full[:, b]
    length = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return torch.cat([vec / length, length], dim=-1)


def exchanged_kps(kps_full, is_ori: bool, tab: LossTables):
    """Pair sample i with B-1-i and swap the bone orientations ('ori') or
    the bone lengths ('m'), then integrate the keypoints from the root."""
    skl = skeleton(kps_full, tab)
    out = skl.clone()
    if is_ori:
        keep = torch.as_tensor(NEWSKL_KEEP, device=skl.device)
        out[:, keep, :3] = torch.flip(skl[:, keep, :3], dims=(0,))
    else:
        keep = torch.as_tensor(SKL_KEEP, device=skl.device)
        out[:, keep, 3] = torch.flip(skl[:, keep, 3], dims=(0,))
    vec = out[..., :3] * out[..., 3:4]
    return keep_kps(-torch.einsum("jk,bkd->bjd", tab.path, vec))


def partae_loss(model, params, tab, jreg, batch, interp, exc, fac: float,
                is_ori: bool):
    """The multi-branch loss of one PartAE step: batches are dicts of
    "verts" [B, V+1, 3] (normalised, dummy row) and "measure" [B, 32]."""
    tx, txi, txe = batch["verts"], interp["verts"], exc["verts"]
    kps_full = regress(jreg, tx[:, :-1])
    kps_i = regress(jreg, txi[:, :-1])
    kps_e = regress(jreg, txe[:, :-1])
    newkps_i = keep_kps(kps_i)
    newkps_e = exchanged_kps(kps_e, is_ori, tab)
    sizes = [tx.shape[0], txi.shape[0], txe.shape[0]]
    z, zk, dummy = model.encode(
        params, torch.cat([tx, txi, txe]),
        torch.cat([keep_kps(kps_full), newkps_i, newkps_e]))
    a_full = torch.ones((sizes[1], model.n_parts), device=tx.device)
    a_full[:, NOLEAF_PART_INDICES] = float(np.float32(fac))
    scale = torch.cat([torch.ones((sizes[0], model.n_parts),
                                  device=tx.device), a_full,
                       torch.ones((sizes[2], model.n_parts),
                                  device=tx.device)])
    rec_all = model.decode(params, z * scale[:, :, None], zk, dummy)
    rec, rec_i, rec_e = torch.split(rec_all, sizes)
    z0 = z[:sizes[0]]
    loss = l1(tx, rec)
    gt = edge_lengths(tx[:, :-1], tab.faces) + 1e-5
    loss = loss + 1e-2 * torch.mean(torch.abs(
        edge_lengths(rec[:, :-1], tab.faces) / gt - 1.0))
    zn = torch.sqrt(torch.sum(z0 ** 2, dim=2))[:, NOLEAF_PART_INDICES]
    m = batch["measure"][:, NOLEAF_IN_MEASURE]
    loss = loss + 1e-2 * l1(zn / m, torch.ones_like(m))
    loss = loss + l1(keep_kps(regress(jreg, rec_i[:, :-1])), newkps_i)
    loss = loss + 1e-2 * distance_loss(txi[:, :-1], rec_i[:, :-1], kps_i,
                                       tab, a_full)
    if is_ori:
        vg = part_volumes(txe[:, :-1], tab.faces, tab.face_mask)
        vr = part_volumes(rec_e[:, :-1], tab.faces, tab.face_mask)
        loss = loss + 1e-2 * torch.mean(torch.abs(torch.abs(vr / vg) - 1.0))
    loss = loss + l1(keep_kps(regress(jreg, rec_e[:, :-1])), newkps_e)
    loss = loss + 1e-2 * distance_loss(txe[:, :-1], rec_e[:, :-1], kps_e, tab)
    return loss


def baseline_loss(model, params, tab, batch):
    """The neural3DMM step's loss: reconstruction and edgereg."""
    tx = batch["verts"]
    rec, _z = model.forward(params, tx)
    gt = edge_lengths(tx[:, :-1], tab.faces) + 1e-5
    return l1(tx, rec) + 1e-2 * torch.mean(torch.abs(
        edge_lengths(rec[:, :-1], tab.faces) / gt - 1.0))


def normalise(verts, jreg):
    """zeroroot: subtract keypoint 0, then append the zero dummy row."""
    root = torch.einsum("v,bvd->bd", jreg[0], verts)
    v = verts - root[:, None]
    return torch.cat([v, v.new_zeros((v.shape[0], 1, 3))], dim=1)


# the recipe's settings that this reference implements and does not read
RECIPE = {"edgereg_epoch": 0, "edgereg_w": 0.01, "zpartreg_epoch": 0,
          "zpartreg_w": 0.01, "vol_epoch": 0, "vol_w": 0.01,
          "interp_epoch": 0, "interp_kps_w": 1.0, "interp_euc_w": 0.01,
          "exc_epoch": 0, "exc_kps_w": 1.0, "exc_euc_w": 0.01,
          "w_mode": "threshold", "w_threshold": 0.8, "w_part_mode": "1/K",
          "relat_flag": True, "edit_mode": "equal", "exc_mode": "ori_or_m",
          "editskl_flag": False, "leafkeep_flag": True, "skip_nonfinite": 0}


def follow(model, leaves0, rebuild, tab, jreg, verts, measures, tr: dict,
           seed: int, n_steps: int = 3, part_model: bool = True,
           rows=None, normalization: str = "zeroroot"):
    """The first n_steps of a run from the parameters leaves0 (a list;
    rebuild(list) -> the tree): -> {"loss": [n_steps], "grad": the first
    step's gradient as Adam took it in, per leaf, "raw": the first step's
    raw gradient per leaf, "delta": the parameters' change after
    n_steps, per leaf}.  `rows` (index array -> index array), where given,
    picks the rows of every batch that the step reads: a fault to plant."""
    bad = {k: (tr.get(k), v) for k, v in RECIPE.items() if tr.get(k) != v}
    if bad:
        raise ValueError(f"the reference implements other settings: {bad}")
    if normalization != "zeroroot":
        raise ValueError("the reference implements zeroroot normalisation")
    n = verts.shape[0]
    spe = n // tr["batch_train"]
    order = batch_order(n, tr["batch_train"], seed, 1)
    cyc = interp_cycle(n, tr["batch_interp"], seed, 1)
    draws = edit_draws(seed, 1, tuple(tr["factor"]))
    params = [p.detach().clone() for p in leaves0]
    state = {"mu": [torch.zeros_like(p) for p in params],
             "nu": [torch.zeros_like(p) for p in params]}
    out = {"loss": []}

    def take(idx):
        if rows is not None:
            idx = rows(idx)
        idx = torch.as_tensor(idx, device=verts.device)
        return {"verts": normalise(verts[idx], jreg),
                "measure": None if measures is None else measures[idx]}

    for step in range(n_steps):
        leaves = [p.requires_grad_(True) for p in params]
        if part_model:
            bi, be = next(cyc), next(cyc)
            variant, fac = next(draws)
            loss = partae_loss(model, rebuild(leaves), tab, jreg,
                               take(order[step]), take(bi), take(be), fac,
                               variant == "ori")
        else:
            loss = baseline_loss(model, rebuild(leaves), tab,
                                 take(order[step]))
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        with torch.no_grad():
            params, state, taken = adam([p.detach() for p in leaves],
                                        grads, state, step, tr, spe)
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = [float(torch.linalg.vector_norm(g)) for g in taken]
            out["raw"] = [float(torch.linalg.vector_norm(g)) for g in grads]
    out["delta"] = [float(torch.linalg.vector_norm(p - p0))
                    for p, p0 in zip(params, leaves0)]
    return out
