"""Trainer: init, train, validate, evaluate (the port's counterpart of
`semantichuman_tpu/train/loop.py`).

  hierarchy (loaded) -> assets -> model -> loss tables -> optimizer
  -> step cache -> epoch loop (train / val) -> checkpoints
  -> final eval + prediction export

It runs on one device, the card unless the caller asks for the CPU, on
one of two paths, as the JAX Trainer does:

  * the epoch path (train.epoch_scan, on by default; `_epoch_scan_ok`):
    a chunk of epochs (up to train.scan_epochs, clipped at every
    checkpoint, validation, sample dump and loss-gate change) has its
    whole schedule (batch indices, edit specs, Adam's lr and bias
    corrections) staged on the device once, and each step reads its row
    there (`step.py:make_epoch_scan_step`).  On the card the step is
    captured once per (loss flags, exchange variant) as a CUDA graph
    (`graph.py`) and replayed once per step; on the CPU the same step
    runs uncaptured.  A capture that fails raises: the Trainer does not
    fall back to the loop.
  * the loop (epoch_scan off, data that is not staged, or the neural3DMM
    baseline): eager steps, their batches and edit specs moved to the
    device one step at a time.

The model is PartAE ('multiz+partkps') or the baseline SpiralAE
('neural3DMM', whose step is reconstruction and edgereg alone).  A run
starts from train.seed, from the port's checkpoint (train.resume), or
from a reference `.pth.tar` (train.resume_torch, `utils/import_torch.py`:
its weights, and unless train.finetune its Adam moments, Adam's count and
the lr schedule's position, epoch x steps_per_epoch).

Both paths reseed the batch shuffle, the edit sampler and the interp/exc
cycle from the epoch number, so they replay the JAX Trainer's batch,
edit-spec and exc-variant schedule exactly, a resumed run replays the
uninterrupted one, and a checkpoint written by one path resumes in the
other.  Per-step losses stay on the device until the epoch (or chunk)
ends; validation and evaluation sums accumulate on the device and are read
once per pass.

Data comes from the synthetic generator (data.synthetic) or from an
on-disk dataset (`BodyAssets.load`, then `MeshData`'s memmapped splits on
the stacked layout or `FileSource` on the per-sample one), and the
hierarchy from the topology compiler, cached as
`<workdir>/topology_<ds tag>.npz` beside its compile key (the bundled
`assets/topology_synth_full_<tag>.npz` serves where its key matches, the
default synthetic template), or from the reference's hierarchy pickle
(data.reference_hierarchy).  On the loop, a worker thread prepares and
copies the next train batches (`prefetch_to_device`, data.prefetch).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data.assets import BodyAssets
from ..data.dataset import (ArraySource, BatchLoader, FileSource, MeshData,
                            compute_stats, place_batch, prefetch_to_device)
from ..data.device_data import (DeviceBatchLoader, DeviceDataSource,
                                gt_bytes)
from ..models import build_model
from ..topology import MeshHierarchy, compile_topology
from ..topology.compiler import read_meta, topology_key
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.params import tree_paths
from . import graph as G
from . import losses as L
from .edits import EditSampler
from .optim import AdamState, make_optimizer
from .step import (EpochBuffers, flags_for_epoch, make_baseline_train_step,
                   make_epoch_scan_step, make_eval_step, make_train_step,
                   to_device)

BUNDLED_TOPOLOGY_DIR = Path(__file__).resolve().parents[2] / "assets"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                               f"section 1, '{item}'")


def load_topology(cfg: Config, assets: BodyAssets,
                  workdir: str) -> MeshHierarchy:
    """The reference's hierarchy pickle (data.reference_hierarchy), or the
    compiler's hierarchy of the assets' template: the bundled one where its
    compile key matches, else compiled into (or read back from)
    `<workdir>/topology_<tag>.npz`.  The Trainer and `cli/export.py` load
    their hierarchy here, so an exported bundle has its checkpoint's."""
    m = cfg.model
    tag = "".join(str(f) for f in m.ds_factors)
    tv = assets.template_verts
    ref_vertex = min(414, len(tv) - 1)
    if cfg.data.reference_hierarchy:
        from ..topology.reference_import import (
            check_template_match, hierarchy_from_reference_pickle)
        hier = hierarchy_from_reference_pickle(
            cfg.data.reference_hierarchy, step_sizes=m.step_sizes,
            dilation=m.dilation, reference_vertex=ref_vertex,
            cache_path=os.path.join(workdir, f"topology_ref_{tag}.npz"))
        check_template_match(hier, tv)
        return hier
    bundled = str(BUNDLED_TOPOLOGY_DIR / f"topology_synth_full_{tag}.npz")
    key = topology_key(tv, assets.template_faces, m.ds_factors,
                       m.step_sizes, m.dilation, ref_vertex)
    if os.path.exists(bundled) and read_meta(bundled) == key:
        return MeshHierarchy.load(bundled)
    # the workdir cache is trusted only where its .meta holds this key
    return compile_topology(
        tv, assets.template_faces, ds_factors=m.ds_factors,
        step_sizes=m.step_sizes, dilation=m.dilation,
        reference_vertex=ref_vertex,
        cache_path=os.path.join(workdir, f"topology_{tag}.npz"))


class Trainer:
    def __init__(self, cfg: Config, workdir: str,
                 assets: BodyAssets | None = None, data=None,
                 device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        t = cfg.train
        if t.resume and t.resume_torch:
            raise ValueError("set train.resume OR train.resume_torch, "
                             "not both")
        if t.profile_stop > t.profile_start:
            raise _not_ported("the profiling window (TraceWindow)",
                              "the trace window")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise _not_ported("data-parallel training", "DDP")
        self.is_part_model = cfg.model.model_type == "multiz+partkps"
        for sub in ("checkpoints", "summaries", "samples", "predictions"):
            os.makedirs(os.path.join(workdir, sub), exist_ok=True)

        # --- assets + data ----------------------------------------------------
        self._synthetic = None
        if assets is None:
            if cfg.data.synthetic:
                assets, self._synthetic = BodyAssets.synthetic(
                    n_theta=cfg.data.synthetic_n_theta,
                    n_phi=cfg.data.synthetic_n_phi)
            else:
                assets = BodyAssets.load(
                    cfg.data.asset_dir,
                    os.path.join(cfg.data.root_dir, "template",
                                 "template.obj"))
        elif cfg.data.synthetic and data is None:
            from ..data.synthetic import SyntheticHuman
            self._synthetic = SyntheticHuman(
                n_theta=cfg.data.synthetic_n_theta,
                n_phi=cfg.data.synthetic_n_phi)
            if (len(self._synthetic.template_verts)
                    != len(assets.template_verts)):
                raise ValueError(
                    f"explicit assets have {len(assets.template_verts)} "
                    "template vertices but the synthetic generator makes "
                    f"{len(self._synthetic.template_verts)}: set "
                    "data.synthetic_n_theta/n_phi to match the assets")
        self.assets = assets
        self._setup_data(data)

        # --- topology, model, losses, optimizer -------------------------------
        self.hierarchy = load_topology(cfg, assets, workdir)
        self.model = build_model(cfg.model, self.hierarchy, assets.part_dict,
                                 device=self.device)
        self.tables = L.build_loss_tables(
            assets.template_faces, assets.j_regressor, assets.part_dict,
            device=self.device)
        self.steps_per_epoch = max(len(self.train_loader), 1)
        self.optimizer = make_optimizer(
            t.lr, t.weight_decay, t.lr_decay, self.steps_per_epoch,
            warmup_epochs=t.lr_warmup_epochs, schedule_kind=t.lr_schedule,
            n_epochs=t.n_epochs, grad_clip=t.grad_clip, adam_b2=t.adam_b2,
            skip_nonfinite=t.skip_nonfinite)
        self.params = self.model.init(t.seed)
        self.opt_state = self.optimizer.init(self.params)
        self.start_epoch = 1
        self.global_step = 0
        if t.resume:
            self._resume(t.resume, t.finetune)
        elif t.resume_torch:
            self._resume_torch(t.resume_torch, t.finetune)
        self.device_data = None
        self._maybe_stage_device_data()

        self.sampler = EditSampler(
            edit_mode=t.edit_mode, rand_mode=t.rand_mode, factor=t.factor,
            noleaf_flag=t.noleaf_flag, editskl_flag=t.editskl_flag,
            exc_mode=t.exc_mode, seed=t.seed)
        self.logger = MetricsLogger(os.path.join(workdir, "summaries"))
        self.history = []          # per epoch: {"epoch", "train", "val", "sec"}
        self._step_cache: dict = {}
        self._eval_steps: dict = {}
        self._epoch_buffers = None      # the epoch path's static tensors
        self._graph_pool = None         # one memory pool for its graphs

    # --- data ------------------------------------------------------------------
    def _setup_data(self, data):
        cfg = self.cfg
        self.mesh_data = None
        if data is not None:
            self.data = data
            self.stats = None
        elif cfg.data.synthetic:
            sh = self._synthetic
            train = sh.sample_meshes(cfg.data.synthetic_train,
                                     seed=cfg.train.seed)
            test = sh.sample_meshes(cfg.data.synthetic_test,
                                    seed=cfg.train.seed + 1)
            self.data = {
                "train": ArraySource(train.astype(np.float32),
                                     sh.measures(train).astype(np.float32)),
                "val": ArraySource(test.astype(np.float32)),
                "test": ArraySource(test.astype(np.float32)),
            }
            self.stats = compute_stats(train, test, cfg.data.normalization)
        else:
            self._setup_file_data()
        t = cfg.train
        common = dict(normalization=cfg.data.normalization,
                      j_regressor=self.assets.j_regressor, stats=self.stats)
        self.train_loader = BatchLoader(
            self.data["train"], t.batch_train, shuffle=cfg.data.shuffle,
            seed=t.seed, drop_last=True, **common)
        self.interp_loader = BatchLoader(
            self.data["train"], t.batch_interp, shuffle=cfg.data.shuffle,
            seed=t.seed + 101, drop_last=True, **common)
        self.val_loader = BatchLoader(
            self.data["val"], t.batch_test, shuffle=False, seed=0,
            pad_final=True, **common)
        self.test_loader = BatchLoader(
            self.data["test"], t.batch_test, shuffle=False, seed=0,
            pad_final=True, **common)

    def _setup_file_data(self):
        """The on-disk dataset under data.root_dir: MeshData's memmapped
        splits (data.from_stacked) or the per-sample FileSource layout."""
        cfg = self.cfg
        root = os.path.join(cfg.data.root_dir, "preprocessed")
        n_val = cfg.data.n_val
        val_paths = os.path.join(root, "paths_val.npy")
        if (cfg.data.from_stacked and n_val == 0
                and os.path.exists(val_paths)):
            # the val split data_generation carved: the stacked path must
            # not train on the val samples
            n_val = len(np.load(val_paths))
        md = MeshData(cfg.data.root_dir, n_val, cfg.data.normalization)
        self.mesh_data = md
        self.stats = md.stats
        if not cfg.data.from_stacked:
            self.data = {
                split: FileSource(root, split, measure=cfg.data.measure
                                  and split == "train")
                for split in ("train", "val", "test")
                if os.path.exists(os.path.join(root, f"paths_{split}.npy"))}
            if "train" not in self.data:
                raise FileNotFoundError(
                    f"{root}/paths_train.npy is missing (run "
                    "cli.data_generation, or set data.from_stacked: true)")
            if "val" not in self.data and "test" not in self.data:
                raise ValueError(f"no val or test split under {root}")
            self.data.setdefault("val", self.data.get("test"))
            self.data.setdefault("test", self.data["val"])
            return
        meas = None
        mpath = os.path.join(root, "train_measurements.npy")
        if cfg.data.measure:
            if not os.path.exists(mpath):
                raise FileNotFoundError(
                    f"data.measure=True but {mpath} is missing (run "
                    "cli.obj2npy, or set data.measure: false)")
            meas = np.load(mpath, mmap_mode="r")
        self.data = {"train": ArraySource(
            md.vertices_train,
            None if meas is None else meas[:len(md.vertices_train)])}
        if md.vertices_test is not None:
            self.data["test"] = ArraySource(md.vertices_test)
        if len(md.vertices_val):
            self.data["val"] = ArraySource(md.vertices_val)
        if "val" not in self.data and "test" not in self.data:
            raise ValueError("no val or test split: provide preprocessed/"
                             "test.npy or set data.n_val > 0")
        self.data.setdefault("val", self.data.get("test"))
        self.data.setdefault("test", self.data["val"])

    def _maybe_stage_device_data(self):
        """Stage array splits on the device and swap the loaders for
        on-device batches.  data.device_resident: True / False / 'auto'
        (on when the splits and the GT loss inputs of the train/interp
        source fit data.device_resident_max_gb)."""
        mode = self.cfg.data.device_resident
        if mode is False or mode == "false":
            return
        loaders = {"train": self.train_loader, "interp": self.interp_loader,
                   "val": self.val_loader, "test": self.test_loader}
        sources = {id(ld.source): ld.source for ld in loaders.values()}
        train_ids = {id(self.train_loader.source),
                     id(self.interp_loader.source)}
        supported = all(isinstance(s, ArraySource) for s in sources.values())
        n_faces = len(self.assets.template_faces)
        n_vol = self.tables.face_part_mask.shape[1]
        # a per-sample FileSource holds no array to count (the JAX
        # Trainer's count raises on one)
        total = sum(
            int(np.prod(s.verts.shape)) * 4
            + (0 if s.measures is None else int(np.prod(s.measures.shape)) * 4)
            + (gt_bytes(len(s), n_faces, n_vol) if sid in train_ids else 0)
            for sid, s in sources.items()) if supported else 0
        budget = float(self.cfg.data.device_resident_max_gb) * 1e9
        if not supported or total > budget:
            if mode is True or mode == "true":
                raise ValueError(
                    "data.device_resident=True but the dataset cannot be "
                    f"staged (array-backed={supported}, bytes={total:.3g} "
                    f"vs budget {budget:.3g})")
            return
        faces = np.asarray(self.assets.template_faces)
        mask = self.tables.face_part_mask.cpu().numpy()
        staged = {
            sid: DeviceDataSource(
                src.verts, src.measures, self.cfg.data.normalization,
                j_regressor=self.assets.j_regressor, stats=self.stats,
                device=self.device,
                # GT loss inputs only where a train step reads them
                gt_faces=faces if sid in train_ids else None,
                gt_face_part_mask=mask if sid in train_ids else None)
            for sid, src in sources.items()}
        self.device_data = staged
        for name in ("train_loader", "interp_loader", "val_loader",
                     "test_loader"):
            ld = getattr(self, name)
            setattr(self, name, DeviceBatchLoader(ld, staged[id(ld.source)]))

    def _put(self, batch: dict) -> dict:
        return place_batch(batch, self.device)

    @staticmethod
    def _step_view(batch: dict) -> dict:
        """The tensors a step reads (host-side ids stay out)."""
        return {k: batch[k] for k in ("verts", "measure", "gt_face_edges",
                                      "gt_part_vols") if k in batch}

    # --- checkpoint -------------------------------------------------------------
    def _ckpt_dir(self):
        return os.path.join(self.workdir, "checkpoints")

    def _resume(self, resume_dir: str, finetune: bool):
        state, _ = restore_checkpoint(resume_dir, device=self.device)
        self.params = state["params"]
        if not finetune:
            self.opt_state = AdamState(**state["opt_state"])
            self.start_epoch = int(state["epoch"]) + 1
            self.global_step = int(state["step"])

    def _resume_torch(self, path: str, finetune: bool):
        """Continue from a reference `.pth.tar`: the weights always; Adam's
        moments, its count and the lr schedule's position unless finetune
        (reference main.py:277-292: finetune loads weights only and
        restarts from epoch 1)."""
        from ..utils.import_torch import load_reference_training_state
        params, opt_state, epoch = load_reference_training_state(
            path, self.model, self.steps_per_epoch,
            lr_decay=self.cfg.train.lr_decay)
        # the moments follow the imported tree's leaf order: it must be
        # the Trainer's own
        if tree_paths(params) != tree_paths(self.params):
            raise ValueError(f"{path}: the imported parameters' key paths "
                             "differ from the model's")
        self.params = params
        if finetune:
            return
        if opt_state is None:
            raise ValueError(
                f"{path} carries no optimizer state — pass "
                "train.finetune=True to start a fresh schedule from its "
                "weights")
        self.opt_state = opt_state
        self.start_epoch = epoch + 1
        self.global_step = epoch * self.steps_per_epoch

    def save(self, epoch: int):
        save_checkpoint(self._ckpt_dir(), epoch, {
            "params": self.params,
            "opt_state": vars(self.opt_state),
            "epoch": epoch, "step": self.global_step},
            max_to_keep=self.cfg.train.ck_keep)

    # --- steps ------------------------------------------------------------------
    def _get_step(self, epoch: int, variant: str):
        flags = flags_for_epoch(self.cfg.train, epoch)
        key = (flags, variant)
        if key not in self._step_cache:
            if self.is_part_model:
                self._step_cache[key] = make_train_step(
                    self.model, self.tables, self.optimizer, flags, variant)
            else:
                self._step_cache[key] = make_baseline_train_step(
                    self.model, self.tables, self.optimizer, flags)
        return self._step_cache[key]

    def _get_eval_step(self, mm_constant: float = 1000.0):
        key = float(mm_constant)
        if key not in self._eval_steps:
            self._eval_steps[key] = make_eval_step(self.model, self.tables,
                                                   mm_constant)
        return self._eval_steps[key]

    def _interp_measure(self, interp_b: dict):
        """Host measures of the interp batch: only edit_mode='exc' reads
        them."""
        m = interp_b.get("measure")
        if m is None or self.cfg.train.edit_mode != "exc":
            return None
        return m.cpu().numpy()

    # --- main loop ---------------------------------------------------------------
    def dump_part_template(self):
        """Part-coloured template OBJ at train start."""
        from ..data.assets import part_color_map
        from ..topology.obj_io import save_obj
        v = self.assets.template_verts
        save_obj(os.path.join(self.workdir, "samples", "template_parts.obj"),
                 v, self.assets.template_faces,
                 vert_colors=part_color_map(self.assets.part_dict, len(v)))

    def _dump_train_params(self):
        """The resolved config (and the code revision, where git knows it)
        into checkpoints/train_params.txt, once per Trainer."""
        if getattr(self, "_params_dumped", False):
            return
        self._params_dumped = True
        sha = None
        try:
            sha = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            pass
        with open(os.path.join(self._ckpt_dir(), "train_params.txt"),
                  "a") as f:
            f.write(json.dumps({"git_sha": sha,
                                "start_epoch": self.start_epoch,
                                "config": self.cfg.to_dict()},
                               indent=2, default=str) + "\n")

    def fit(self, n_epochs: int | None = None):
        cfg = self.cfg
        n_epochs = n_epochs or cfg.train.n_epochs
        if len(self.train_loader) == 0:
            raise ValueError(
                f"train split has {len(self.data['train'])} samples, fewer "
                f"than batch_train={cfg.train.batch_train} (drop_last)")
        if self.is_part_model and len(self.interp_loader) == 0:
            raise ValueError(
                f"train split has {len(self.data['train'])} samples, fewer "
                f"than batch_interp={cfg.train.batch_interp} (drop_last)")
        self._dump_train_params()
        if self.start_epoch == 1 and cfg.train.save_recons:
            self.dump_part_template()
        use_scan = self._epoch_scan_ok()
        epoch = self.start_epoch
        while epoch <= n_epochs:
            t0 = time.time()
            if use_scan:
                e1 = self._scan_chunk_end(epoch, n_epochs)
                tlosses, metrics, last_batch = self._run_scan_chunk(epoch,
                                                                    e1)
            else:
                # per-epoch deterministic state: the batch order, the
                # edit-spec RNG and the interp/exc schedule are functions
                # of the epoch, so resume-at-E replays the uninterrupted
                # run's epoch E (the epoch path builds each epoch of a
                # chunk the same way)
                e1 = epoch
                self.train_loader.set_epoch(epoch)
                self.sampler.reseed(epoch)
                interp_iter = self.interp_loader.cycle(anchor=epoch)
                tl, metrics, last_batch = self._run_epoch_steps(epoch,
                                                                interp_iter)
                tlosses = [tl]
            self.logger.log(self.global_step, metrics)
            train_sec = (time.time() - t0) / len(tlosses)
            for i, e in enumerate(range(epoch, e1 + 1)):
                t1 = time.time()
                vloss = None
                if e == e1 and (e % max(cfg.train.val_every, 1) == 0
                                or e == n_epochs):
                    vloss = self.validate()
                sec = train_sec + time.time() - t1
                ep_metrics = {"epoch_train": tlosses[i]}
                if vloss is not None:
                    ep_metrics["epoch_val"] = vloss
                self.logger.log(e, ep_metrics, prefix="epoch")
                self.history.append({"epoch": e, "train": tlosses[i],
                                     "val": vloss, "sec": sec,
                                     "train_sec": train_sec})
                vtxt = "-" if vloss is None else f"{vloss:.6f}"
                print(f"epoch {e} | tr {tlosses[i]:.6f} | val {vtxt} | "
                      f"{sec:.1f}s", flush=True)
                if e % cfg.train.ck_frequency == 0:
                    self.save(e)
                if (cfg.train.save_recons and e % 50 == 0
                        and last_batch is not None):
                    self._dump_sample(e, last_batch)
            epoch = e1 + 1
        return self

    def _scan_chunk_end(self, e0: int, n_epochs: int) -> int:
        """The last epoch e1 >= e0 of the chunk that starts at e0: at most
        train.scan_epochs epochs, and never past an epoch that needs the
        host after it (checkpoint, validation, sample dump) or a change of
        the loss flags (another step).  The boundary test covers e0 too: a
        chunk that crossed a boundary would save end-of-chunk parameters
        under the boundary's epoch and skip its validation."""
        t = self.cfg.train
        e1 = min(e0 + max(t.scan_epochs, 1) - 1, n_epochs)
        f0 = flags_for_epoch(t, e0)
        e = e0
        while e < e1:
            if (e % t.ck_frequency == 0
                    or e % max(t.val_every, 1) == 0
                    or (t.save_recons and e % 50 == 0)):
                break
            if flags_for_epoch(t, e + 1) != f0:
                break
            e += 1
        return e

    def _run_epoch_steps(self, epoch: int, interp_iter):
        """One epoch as a loop of steps; losses stay on the device until it
        ends (reading each would make the host wait for the card)."""
        cfg = self.cfg
        step_losses, step_sizes = [], []
        last_batch, metrics = None, {}
        batches = prefetch_to_device(iter(self.train_loader), self.device,
                                     size=cfg.data.prefetch)
        for batch in batches:
            if self.is_part_model:
                interp_b = self._put(next(interp_iter))
                exc_b = self._put(next(interp_iter))
                variant = self.sampler.sample_exc_variant()
                spec = to_device(self.sampler.sample_interp(
                    epoch, interp_b["verts"].shape[0],
                    measure=self._interp_measure(interp_b)), self.device)
                step = self._get_step(epoch, variant)
                self.params, self.opt_state, metrics = step(
                    self.params, self.opt_state, self._step_view(batch),
                    self._step_view(interp_b), self._step_view(exc_b), spec)
            else:
                step = self._get_step(epoch, "ori")
                self.params, self.opt_state, metrics = step(
                    self.params, self.opt_state, self._step_view(batch))
            step_losses.append(metrics["loss"])
            step_sizes.append(batch["verts"].shape[0])
            self.global_step += 1
            if cfg.train.log_every and (
                    self.global_step % cfg.train.log_every == 0):
                self.logger.log(self.global_step, _to_host(metrics))
            last_batch = batch
        losses = torch.stack(step_losses).double().cpu().numpy()
        sizes = np.asarray(step_sizes, np.float64)
        epoch_loss = float((losses * sizes).sum() / max(sizes.sum(), 1.0))
        return epoch_loss, _to_host(metrics), last_batch

    # --- the epoch path ---------------------------------------------------------
    def _epoch_scan_ok(self) -> bool:
        """The epoch path applies with the JAX Trainer's prerequisites: the
        flag on, the part model (the baseline trains through the loop),
        one process, no trace window, and device-resident train and interp
        loaders over one source."""
        t = self.cfg.train
        dist = torch.distributed
        return bool(
            t.epoch_scan
            and self.is_part_model
            and not (dist.is_available() and dist.is_initialized()
                     and dist.get_world_size() > 1)
            and not t.profile_stop > t.profile_start
            and isinstance(self.train_loader, DeviceBatchLoader)
            and isinstance(self.interp_loader, DeviceBatchLoader)
            and self.train_loader.source is self.interp_loader.source)

    def _get_scan_step(self, epoch: int, variant: str):
        """(run, step): run() is one step of the epoch path on the
        Trainer's EpochBuffers, on the card the replay of a graph captured
        at first use per (loss flags, exchange variant), on the CPU the
        step itself; step.metric_names name its metric columns once it has
        run."""
        key = ("scan", flags_for_epoch(self.cfg.train, epoch), variant)
        if key not in self._step_cache:
            buf = self._epoch_buffers
            step = make_epoch_scan_step(
                self.model, self.tables, self.optimizer, key[1], variant,
                self.train_loader.source.batch_fn)
            if self.device.type == "cuda":
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()

                def reset():
                    buf.k.zero_()
                    buf.pos.zero_()

                G.warm_up(lambda: step(buf), reset)
                run = G.capture(lambda: step(buf), self._graph_pool).replay
            else:
                def run():
                    step(buf)
            # the step (and the tables it closes over) lives as long as
            # its graph: a replay reads every tensor the capture saw
            self._step_cache[key] = (run, step)
        return self._step_cache[key]

    def _run_scan_chunk(self, e0: int, e1: int):
        """Epochs e0..e1 on the epoch path: the host builds each epoch's
        batch, edit-spec and exc-variant schedule as the loop does
        (set_epoch, reseed, the anchored interp cycle) and Adam's scalars
        for every step, stages them on the device in one copy, runs the
        step once per row, and reads the metrics once at the end.
        -> (per-epoch train losses, the last step's metrics with the
        chunk's largest gnorm, the last batch or None)."""
        cfg = self.cfg
        src = self.train_loader.source
        exc_dyn = self.sampler.exc_mode == "ori_or_m"
        host_meas = self.interp_loader.loader.source.measures
        idx_tr, idx_in, idx_ex, specs, epoch_of_step = [], [], [], [], []
        variant = last_meta = None
        for e in range(e0, e1 + 1):
            self.train_loader.set_epoch(e)
            self.sampler.reseed(e)
            interp_metas = self.interp_loader.meta_cycle(anchor=e)
            for meta in self.train_loader.loader.iter_indices():
                mi, me = next(interp_metas), next(interp_metas)
                idx_tr.append(meta["global_idx"])
                idx_in.append(mi["global_idx"])
                idx_ex.append(me["global_idx"])
                variant = self.sampler.sample_exc_variant()
                measure = None
                if cfg.train.edit_mode == "exc":
                    measure = np.asarray(host_meas)[mi["global_idx"]]
                spec = self.sampler.sample_interp(
                    e, len(mi["global_idx"]), measure=measure)
                if exc_dyn:
                    spec["exc_is_ori"] = np.float32(variant == "ori")
                specs.append(spec)
                epoch_of_step.append(e)
                last_meta = meta
        k = len(idx_tr)
        sched = {"idx_tr": np.stack(idx_tr).astype(np.int64),
                 "idx_in": np.stack(idx_in).astype(np.int64),
                 "idx_ex": np.stack(idx_ex).astype(np.int64),
                 **{f"spec:{n}": np.stack([s[n] for s in specs])
                    for n in specs[0]}}
        if self._epoch_buffers is None:
            self._epoch_buffers = EpochBuffers(
                self.params, max(cfg.train.scan_epochs, 1)
                * self.steps_per_epoch, self.device)
        buf = self._epoch_buffers
        buf.stage(sched, self.optimizer.step_scalars(
            self.opt_state.count, k, self.opt_state.schedule_offset))
        run, step = self._get_scan_step(e0,
                                        "dynamic" if exc_dyn else variant)
        buf.load(self.params, self.opt_state)
        for _ in range(k):
            run()
        ms, applied, bad = buf.read(k)
        self.params, self.opt_state = buf.state_out(self.opt_state, applied,
                                                    bad)
        self.global_step += k
        ms = dict(zip(step.metric_names, ms.T))
        if cfg.train.log_every:
            base = self.global_step - k
            for j in range(k):
                if (base + j + 1) % cfg.train.log_every == 0:
                    self.logger.log(base + j + 1,
                                    {n: float(v[j]) for n, v in ms.items()})
        eps = np.asarray(epoch_of_step)
        sizes = np.full(k, float(cfg.train.batch_train))
        losses = ms["loss"]
        # the loop's formula: the size-weighted mean of the f32 losses in
        # float64
        tlosses = [float((losses[eps == e] * sizes[eps == e]).sum()
                         / max(sizes[eps == e].sum(), 1.0))
                   for e in range(e0, e1 + 1)]
        metrics = {n: float(v[-1]) for n, v in ms.items()}
        # the chunk's largest raw gradient norm: a spike mid-chunk is the
        # signal, which the last step's would hide
        metrics["gnorm"] = float(ms["gnorm"].max())
        last_batch = (src.take(last_meta)
                      if cfg.train.save_recons and e1 % 50 == 0 else None)
        return tlosses, metrics, last_batch

    def validate(self) -> float:
        """Mean per-sample L1 over the val split (pad rows masked)."""
        step = self._get_eval_step()
        total = count = None
        for batch in self.val_loader:
            batch = self._put(batch)
            out = step(self.params, self._step_view(batch))
            valid = batch["valid"]
            s, c = (out["l1"] * valid).sum(), valid.sum()
            total = s if total is None else total + s
            count = c if count is None else count + c
        if total is None:
            return 0.0
        total, count = torch.stack([total, count]).double().cpu().tolist()
        return total / max(count, 1.0)

    def evaluate(self, loader=None, mm_constant: float = 1000.0,
                 unnormalize: bool | None = None):
        """Full test-set eval: (predictions, z, z_kps, inputs, mean L1, mean
        per-vertex mm error).  `unnormalize` (default: on whenever the
        normalization has a scaling mode, 'gass' or 'normal') inverts the
        scaling first, so the mm number is true millimetres."""
        from ..data.dataset import unnormalize_batch
        loader = loader or self.test_loader
        norm = self.cfg.data.normalization
        if unnormalize is None:
            unnormalize = ("gass" in norm) or ("normal" in norm)
        if unnormalize and self.stats is None:
            raise ValueError("unnormalize=True needs dataset stats "
                             "(train with gass/normal normalization)")
        step = self._get_eval_step(mm_constant)
        preds, zs, zkps, txs = [], [], [], []
        l1_sum = l2_sum = None
        l1_host = l2_host = 0.0
        count = 0
        for batch in loader:
            batch = self._put(batch)
            out = step(self.params, self._step_view(batch))
            n_valid = batch["verts"].shape[0] - batch.get("pad", 0)
            rec = out["rec"][:n_valid].cpu().numpy()
            tx = batch["verts"][:n_valid].cpu().numpy()
            if unnormalize:
                idx = np.asarray(batch["global_idx"][:n_valid])
                rec = np.concatenate(
                    [unnormalize_batch(rec[:, :-1], norm, self.stats, idx),
                     rec[:, -1:]], axis=1)
                tx = np.concatenate(
                    [unnormalize_batch(tx[:, :-1], norm, self.stats, idx),
                     tx[:, -1:]], axis=1)
                d = rec[:, :-1] - tx[:, :-1]
                l1_host += float(np.sum(np.mean(np.abs(d), axis=(1, 2))))
                l2_host += float(np.sum(np.mean(np.sqrt(np.sum(
                    (d * mm_constant) ** 2, axis=2)), axis=1)))
            else:
                valid = batch["valid"]
                s1 = (out["l1"] * valid).sum()
                s2 = (out["l2_mm"] * valid).sum()
                l1_sum = s1 if l1_sum is None else l1_sum + s1
                l2_sum = s2 if l2_sum is None else l2_sum + s2
            preds.append(rec)
            zs.append(out["z"][:n_valid].cpu().numpy())
            zkps.append(out["z_kps"][:n_valid].cpu().numpy())
            txs.append(tx)
            count += n_valid
        if l1_sum is not None:
            l1_host, l2_host = torch.stack([l1_sum, l2_sum]).double() \
                .cpu().tolist()
        return (np.concatenate(preds), np.concatenate(zs),
                np.concatenate(zkps), np.concatenate(txs),
                l1_host / count, l2_host / count)

    def export_predictions(self, out_dir: str | None = None):
        out_dir = out_dir or os.path.join(self.workdir, "predictions")
        os.makedirs(out_dir, exist_ok=True)
        preds, z, z_kps, tx, l1, l2 = self.evaluate()
        np.save(os.path.join(out_dir, "predictions.npy"), preds)
        np.save(os.path.join(out_dir, "z_s.npy"), z)
        np.save(os.path.join(out_dir, "z_kps_s.npy"), z_kps)
        np.save(os.path.join(out_dir, "tx_s.npy"), tx)
        with open(os.path.join(self._ckpt_dir(), "train_params.txt"),
                  "a") as f:
            f.write(f"autoencoder: L1 loss {l1}\n")
            f.write(f"autoencoder: euclidean distance in mm {l2}\n")
        return preds, z, z_kps, tx, l1, l2

    def _dump_sample(self, epoch: int, batch: dict):
        """GT and reconstruction OBJ of the batch's first sample."""
        from ..topology.obj_io import save_obj
        res = self._get_eval_step()(self.params, self._step_view(batch))
        gt = batch["verts"][0, :-1].cpu().numpy()
        rec = res["rec"][0, :-1].cpu().numpy()
        sdir = os.path.join(self.workdir, "samples")
        save_obj(os.path.join(sdir, f"epoch{epoch}_GT.obj"), gt,
                 self.assets.template_faces)
        save_obj(os.path.join(sdir, f"epoch{epoch}_rec.obj"), rec,
                 self.assets.template_faces)


def _to_host(metrics: dict) -> dict:
    """Device scalars -> floats in one transfer."""
    if not metrics:
        return {}
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().double().reshape(())
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))
