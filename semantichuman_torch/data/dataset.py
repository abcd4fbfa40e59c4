"""Host data pipeline (the port's copy of
`semantichuman_tpu/data/dataset.py`).

  * `MeshData` - one fixed-topology dataset on disk: the memory-mapped
    `preprocessed/{train,test}.npy` splits (the last n_val train samples
    are the val split), the template mesh, normalization statistics and
    the OBJ export of reconstructions;
  * `ArraySource` - a batch source over an [N, V, 3] array (memmapped or
    in memory); `FileSource` - one over the per-sample
    `points_{split}/NNNNNN.npy` layout that `cli/data_generation.py`
    writes;
  * `compute_stats`, `normalize_batch`, `unnormalize_batch` - the
    substring-matched normalization modes;
  * `BatchLoader` - seeded-shuffle batches with normalization and the dummy
    vertex, the same NumPy shuffles as the JAX package (so both see the
    same batch schedule), `set_epoch` and the resume-safe `cycle(anchor=)`;
  * `place_batch` - a host batch onto the device; `prefetch_to_device` -
    batches built by a worker thread and copied ahead of the step.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..topology.obj_io import load_obj, save_obj


@dataclass
class ShapeStats:
    mean: np.ndarray | None = None     # 'gass': per-vertex mean/std of train
    std: np.ndarray | None = None
    center: np.ndarray | None = None   # 'normal': per-sample bbox center
    scale: np.ndarray | None = None    # 'normal': per-sample 1/bbox-extent


class MeshData:
    """Dataset container for one fixed-topology mesh dataset."""

    def __init__(self, root_dir: str, n_val: int = 0,
                 normalization: str = "No", mmap: bool = True):
        self.root_dir = root_dir
        self.normalization = normalization
        pre = os.path.join(root_dir, "preprocessed")
        mode = "r" if mmap else None
        train = np.load(os.path.join(pre, "train.npy"), mmap_mode=mode)
        if not 0 <= n_val < len(train):
            raise ValueError(f"n_val={n_val} out of range for {len(train)} "
                             f"samples in {pre}/train.npy")
        self.vertices_train = train[:len(train) - n_val]
        self.vertices_val = train[len(train) - n_val:]
        test_path = os.path.join(pre, "test.npy")
        self.vertices_test = (np.load(test_path, mmap_mode=mode)
                              if os.path.exists(test_path) else None)
        self.n_vertex = self.vertices_train.shape[1]
        self.n_features = self.vertices_train.shape[2]
        tpl = os.path.join(root_dir, "template", "template.obj")
        self.template_verts, self.template_faces = load_obj(tpl)
        self.stats = compute_stats(self.vertices_train, self.vertices_test,
                                   self.normalization)

    def save_meshes(self, prefix: str, meshes: np.ndarray, indices,
                    vert_colors=None, kps=None, skl_list=None):
        """Export reconstructed meshes as OBJ, the 'gass' and 'normal'
        normalizations undone with the stored stats (reference:
        shape_data.py:86-145)."""
        for i in range(len(meshes)):
            v = meshes[i].reshape(self.n_vertex, self.n_features)
            if self.normalization == "gass":
                v = v * self.stats.std + self.stats.mean
            elif self.normalization == "normal":
                v = v / self.stats.scale[indices[i]] \
                    + self.stats.center[indices[i]]
            save_obj(f"{prefix}_{str(int(indices[i])).zfill(6)}.obj", v,
                     self.template_faces, vert_colors=vert_colors,
                     kps=None if kps is None else kps[i], skl_list=skl_list)


class ArraySource:
    """Batch source over an in-memory or memmapped [N, V, 3] array."""

    def __init__(self, verts: np.ndarray, measures: np.ndarray | None = None):
        self.verts = verts
        self.measures = measures

    def __len__(self):
        return len(self.verts)

    def take(self, idx: np.ndarray) -> dict:
        out = {"verts": np.asarray(self.verts[idx], dtype=np.float32),
               "idx": idx}
        if self.measures is not None:
            out["measure"] = np.asarray(self.measures[idx], dtype=np.float32)
        return out


class FileSource:
    """Batch source over the per-sample `points_{split}/` directory
    layout."""

    def __init__(self, root_dir: str, split: str, measure: bool = False):
        self.root = root_dir
        self.split = split
        self.names = [str(n) for n in
                      np.load(os.path.join(root_dir, f"paths_{split}.npy"))]
        self.measure = measure

    def __len__(self):
        return len(self.names)

    def take(self, idx: np.ndarray) -> dict:
        pts = np.stack([
            np.load(os.path.join(self.root, f"points_{self.split}",
                                 self.names[i] + ".npy"))
            for i in idx]).astype(np.float32)
        out = {"verts": pts, "idx": idx}
        if self.measure:
            out["measure"] = np.stack([
                np.load(os.path.join(self.root, f"measure_{self.split}",
                                     self.names[i] + ".npy"))
                for i in idx]).astype(np.float32)
        return out


def compute_stats(train_verts, test_verts, normalization: str) -> ShapeStats:
    """Normalization statistics (substring-matched modes compose)."""
    s = ShapeStats()
    if "gass" in normalization:
        s.mean = np.mean(train_verts, axis=0)
        std = np.std(train_verts, axis=0)
        # zero-variance coordinates map to the identity scale
        s.std = np.where(std < 1e-8, 1.0, std)
    if "normal" in normalization:
        # per-sample per-axis bbox stats of the TEST split, indexed by
        # test-sample id (the reference's quirk, kept)
        if test_verts is None:
            raise ValueError("'normal' normalization needs a test split")
        s.center = (np.max(test_verts, axis=1)
                    + np.min(test_verts, axis=1)) / 2
        s.scale = 1.0 / (np.max(test_verts, axis=1)
                         - np.min(test_verts, axis=1))
    return s


def unnormalize_batch(verts: np.ndarray, normalization: str,
                      stats: ShapeStats | None = None,
                      idx: np.ndarray | None = None) -> np.ndarray:
    """Invert the scaling modes ('gass', 'normal') on [B, V, 3] vertices
    (no dummy row), so eval metrics are true millimetres.  Rigid
    translations (zeromean / zeroroot) cancel in differences."""
    v = verts
    if "normal" in normalization:
        v = v / stats.scale[idx][:, None, :] + stats.center[idx][:, None, :]
    if "gass" in normalization:
        v = v * stats.std + stats.mean
    return v


def normalize_batch(verts: np.ndarray, normalization: str,
                    j_regressor: np.ndarray | None = None,
                    stats: ShapeStats | None = None,
                    idx: np.ndarray | None = None) -> np.ndarray:
    """Substring-matched normalization modes, vectorized over the batch."""
    v = verts
    if "zeromean" in normalization:
        v = v - np.mean(v, axis=1, keepdims=True)
    if "zeroroot" in normalization:
        root = np.einsum("v,bvd->bd", j_regressor[0], v)
        v = v - root[:, None, :]
    if "onelength" in normalization:
        ext = (np.max(v, axis=1) - np.min(v, axis=1))[:, 1]
        v = v / ext[:, None, None] * 1.5
    if "small" in normalization:
        v = v / 1.5
    if "gass" in normalization:
        v = (v - stats.mean) / stats.std
    if "normal" in normalization:
        v = (v - stats.center[idx][:, None, :]) * stats.scale[idx][:, None, :]
    return np.nan_to_num(v, nan=0.0)


class BatchLoader:
    """Seeded-shuffle batch iterator with normalization and dummy vertex."""

    # each train epoch gets its own block of shuffle-seed epochs for the
    # endless interp/exc cycle, so a run resumed at epoch E draws what the
    # uninterrupted run drew in epoch E
    EPOCH_ANCHOR_STRIDE = 1 << 16

    def __init__(self, source, batch_size: int, shuffle: bool = False,
                 seed: int = 0, normalization: str = "No",
                 j_regressor: np.ndarray | None = None,
                 stats: ShapeStats | None = None, dummy_node: bool = True,
                 drop_last: bool = False, pad_final: bool = False,
                 process_slice: tuple[int, int] | None = None):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.normalization = normalization
        self.j_regressor = (None if j_regressor is None
                            else np.asarray(j_regressor, np.float32))
        self.stats = stats
        self.dummy_node = dummy_node
        self.drop_last = drop_last
        self.pad_final = pad_final
        # (rank, world): every process walks the same global batch order
        # (same seed and epoch) and keeps its contiguous slice of each
        # batch, rows [rank*per, (rank+1)*per)
        self.process_slice = process_slice
        if process_slice is not None and batch_size % process_slice[1]:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{process_slice[1]} processes")
        self.epoch = 0

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def iter_indices(self):
        """The batch schedule only: {global_idx, pad, valid} dicts."""
        n = len(self.source)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = ((n // self.batch_size) * self.batch_size if self.drop_last
                else n)
        for s in range(0, stop, self.batch_size):
            idx = order[s:s + self.batch_size]
            pad = 0
            if self.pad_final and len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            valid = np.ones(len(idx), np.float32)
            if pad:
                valid[-pad:] = 0.0
            yield {"global_idx": idx, "pad": pad, "valid": valid}

    def local(self, meta: dict) -> tuple:
        """(idx, valid) of this process's rows of a scheduled batch (the
        whole batch without a process_slice)."""
        idx, valid = meta["global_idx"], meta["valid"]
        if self.process_slice is None:
            return idx, valid
        r, w = self.process_slice
        if len(idx) % w:
            raise ValueError(
                f"batch of {len(idx)} not divisible by {w} processes (use "
                "drop_last or pad_final with a divisible batch_size)")
        per = len(idx) // w
        return idx[r * per:(r + 1) * per], valid[r * per:(r + 1) * per]

    def __iter__(self):
        for meta in self.iter_indices():
            idx, valid = self.local(meta)
            batch = self.source.take(idx)
            v = normalize_batch(batch["verts"], self.normalization,
                                self.j_regressor, self.stats, idx)
            if self.dummy_node:
                z = np.zeros((v.shape[0], 1, v.shape[2]), dtype=v.dtype)
                v = np.concatenate([v, z], axis=1)
            batch["verts"] = v
            batch["pad"] = meta["pad"]                  # the global pad count
            batch["valid"] = valid                      # this process's rows
            batch["global_idx"] = meta["global_idx"]    # the global batch
            yield batch

    def cycle(self, anchor: int | None = None):
        """Endless iterator; anchor=E makes the draw sequence a pure
        function of E (resume-safe)."""
        if anchor is not None:
            self.epoch = anchor * self.EPOCH_ANCHOR_STRIDE
        while True:
            yield from self
            self.epoch += 1


def _moves(key, value) -> bool:
    """Whether place_batch puts a batch entry on the device: every numeric
    ndarray but the id vectors."""
    return (isinstance(value, np.ndarray) and value.dtype != object
            and key not in ("idx", "global_idx"))


def place_batch(batch: dict, device) -> dict:
    """Every numeric ndarray of a host batch except the id vectors onto
    `device` as a tensor; scalars, ids and tensors stay as they are."""
    return {k: torch.as_tensor(v, device=device) if _moves(k, v) else v
            for k, v in batch.items()}


def _stage_async(batch: dict, device, stream) -> tuple[dict, object]:
    """A host batch copied to the card on `stream`: each array pinned and
    copied with non_blocking, an event recorded after the copies.
    -> (batch with device tensors, the event)."""
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            if _moves(k, v):
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(device, non_blocking=True)
            else:
                out[k] = v
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _ready(item) -> dict:
    """The consumer's side of _stage_async: its current stream waits for
    the copies, and each copied tensor is marked as used there (so the
    allocator does not hand its memory to the copy stream while the
    consumer's kernels read it)."""
    batch, done = item
    if done is None:
        return batch
    cur = torch.cuda.current_stream()
    cur.wait_event(done)
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(cur)
    return batch


def prefetch_to_device(iterator, device, size: int = 2):
    """Stage `size` batches ahead on `device`.

    A worker thread drives the host work (memmap or file reads,
    normalization, the dummy row) and, on the card, the copies: each
    batch pinned and copied with non_blocking on a side stream, the
    consumer's stream made to wait on an event recorded after the copies
    before it reads them.  numpy kernels and the copies release the GIL,
    so one thread suffices at these batch sizes.  size <= 0 stages each
    batch inline in the consumer's thread.  An error in the worker is
    raised in the consumer; a consumer that stops early (break, close)
    releases the worker."""
    device = torch.device(device)
    if size <= 0:
        for batch in iterator:
            yield place_batch(batch, device)
        return

    import queue as queue_mod
    import threading

    stream = (torch.cuda.Stream(device) if device.type == "cuda" else None)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    sentinel = object()
    errors: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            with (torch.cuda.device(device) if stream is not None
                  else contextlib.nullcontext()):
                for batch in iterator:
                    item = (_stage_async(batch, device, stream)
                            if stream is not None
                            else (place_batch(batch, device), None))
                    if not put(item):
                        return
        except BaseException as e:  # surface loader errors to the consumer
            errors.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, name="sh-torch-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield _ready(item)
    finally:
        # the consumer finished or abandoned the generator: release the
        # worker
        stop.set()
