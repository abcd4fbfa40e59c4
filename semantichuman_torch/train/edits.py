"""Host-side latent-edit sampling for the interp/exc training branches (the
port's copy of `semantichuman_tpu/train/edits.py`).  The same seed draws
the same arrays as the JAX package: both use `random.Random` and
`np.random.default_rng`.

  * a_full [B, 17]      per-part latent scale (1.0 for unedited parts)
  * edited_mask [17]    which parts are edited this step
  * n_edited            number of edited parts ('1/rand_num' weighting)
  * skl_len_factor [31] bone-length multipliers when editskl_flag is on
  * exc_variant         'ori' | 'm' (a 50/50 coin flip under 'ori_or_m')

Reference quirks kept: the noleaf filter removes at most ONE sampled leaf
part per step, and edit_mode='exc' pairs part k of the non-leaf list with
measure column k.
"""

from __future__ import annotations

import random

import numpy as np

from ..constants import (LEAF_PART_INDICES, N_PARTS, NEWSKL_LIST,
                         NOLEAF_PART_INDICES, SKL_KEEP)


class EditSampler:
    def __init__(self, edit_mode: str = "equal", rand_mode: str = "rand",
                 factor=(0.4, 0.8), noleaf_flag: bool = True,
                 editskl_flag: bool = False, exc_mode: str = "ori_or_m",
                 seed: int = 2):
        self.edit_mode = edit_mode
        self.rand_mode = rand_mode
        self.factor = tuple(factor)
        self.noleaf_flag = noleaf_flag
        self.editskl_flag = editskl_flag
        self.exc_mode = exc_mode
        self.seed = seed
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def reseed(self, epoch: int):
        """Per-epoch deterministic RNG: the specs drawn in epoch E are a
        pure function of (seed, E), so a resumed run replays them."""
        mixed = (self.seed + 1) * (1 << 24) + epoch
        self.py_rng = random.Random(mixed)
        self.np_rng = np.random.default_rng(mixed)

    # --- interp branch --------------------------------------------------------
    def sample_interp(self, epoch: int, batch_size: int,
                      measure: np.ndarray | None = None) -> dict:
        f0, f1 = self.factor
        a_full = np.ones((batch_size, N_PARTS), dtype=np.float32)
        edited = np.zeros(N_PARTS, dtype=np.float32)
        skl_len_factor = np.ones(len(NEWSKL_LIST), dtype=np.float32)

        if self.edit_mode == "rand":
            if self.editskl_flag:
                skl_len_factor[SKL_KEEP] = (
                    self.np_rng.random(len(SKL_KEEP)) * f0 + f1)
            if self.rand_mode == "warm_up":
                if epoch < 20:
                    part_num = 1
                elif epoch < 50:
                    part_num = 2
                elif epoch < 75:
                    part_num = 4
                elif epoch < 100:
                    part_num = 8
                else:
                    part_num = self.py_rng.randint(1, N_PARTS)
            else:
                part_num = self.py_rng.randint(1, N_PARTS)
            part_index = self.py_rng.sample(range(N_PARTS), part_num)
            if self.noleaf_flag:
                # reference quirk: drops at most one leaf part
                for leaf in LEAF_PART_INDICES:
                    if leaf in part_index:
                        part_index.remove(leaf)
                        part_num -= 1
                        break
            a = self.np_rng.random(part_num).astype(np.float32) * f0 + f1
            for k, p in enumerate(part_index):
                a_full[:, p] = a[k]
                edited[p] = 1.0
        elif self.edit_mode == "equal":
            if self.editskl_flag:
                skl_len_factor[SKL_KEEP] = (
                    float(self.np_rng.random(1)[0]) * f0 + f1)
            fac = float(self.np_rng.random(1)[0]) * f0 + f1
            for p in NOLEAF_PART_INDICES:
                a_full[:, p] = fac
                edited[p] = 1.0
        elif self.edit_mode == "exc":
            if measure is None:
                raise ValueError("edit_mode='exc' needs the batch measures")
            a = np.flip(measure, axis=0) / measure       # [B, 32]
            for k, p in enumerate(NOLEAF_PART_INDICES):
                a_full[:, p] = a[:, k]
                edited[p] = 1.0
        else:
            raise ValueError(f"unknown edit_mode {self.edit_mode!r}")

        return {
            "a_full": a_full,
            "edited_mask": edited,
            "n_edited": np.float32(edited.sum()),
            "skl_len_factor": skl_len_factor,
        }

    # --- exc branch -------------------------------------------------------------
    def sample_exc_variant(self) -> str:
        """'ori' or 'm': which skeleton component is exchanged this step."""
        if self.exc_mode == "ori_or_m":
            return "ori" if self.np_rng.random(1)[0] > 0.5 else "m"
        if self.exc_mode in ("ori", "m", "ori_m"):
            return self.exc_mode
        raise ValueError(f"unknown exc_mode {self.exc_mode!r}")
