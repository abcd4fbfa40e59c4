"""Editor: the semantic editing suite over a trained model (counterpart of
`semantichuman_tpu/edit/editor.py`).

Wraps (model, params, assets) with encode/decode on the model's device and
the reference demo's four edits (bone-orientation transplant, bone-length
scaling, per-part girth scaling, shape style transfer), latent
interpolation, body measures and OBJ export with part colours and skeleton
polylines (demo.py:56-114, utils_SH.py:163-223).  Meshes go in as numpy
arrays; `encode` returns tensors on the device, the decoders numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import KPS_KEEP, MEASURE_SKL_LIST, NEWSKL_LIST
from ..ops.skeleton import kps2skl, skl2kps
from ..topology.obj_io import save_obj
from ..utils.device import resolve_device
from ..utils.params import tree_map
from . import ops as E


class Editor:
    """model: PartAE on `device`; params: its trained parameters (moved to
    `device`); assets: BodyAssets."""

    def __init__(self, model, params, assets, batch_size: int = 16,
                 device="cuda"):
        dev = resolve_device(device)
        self.device = model.tables.device
        if self.device.type != dev.type or dev.index not in (
                None, self.device.index):
            raise ValueError(f"the model's tables are on {self.device}, "
                             f"the Editor on {dev}: build the model there")
        self.model = model
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.assets = assets
        self.batch_size = batch_size
        self._jreg = torch.as_tensor(
            np.asarray(assets.j_regressor, np.float32), device=self.device)
        self._kps_keep = torch.as_tensor(KPS_KEEP, device=self.device)
        self._girth_tables = None

    @classmethod
    def from_trainer(cls, trainer, **kw) -> "Editor":
        return cls(trainer.model, trainer.params, trainer.assets,
                   device=trainer.device, **kw)

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # --- primitives ----------------------------------------------------------
    @torch.inference_mode()
    def encode(self, verts: np.ndarray) -> dict:
        """verts [B, V, 3] (no dummy row) ->
        dict(z [B,17,nz], z_kps [B,17,nk], dummy, kps_full [B,35,3])."""
        verts = self._in(verts)
        x = torch.cat([verts, torch.zeros_like(verts[:, :1])], dim=1)
        kps_full = torch.einsum("jv,bvc->bjc", self._jreg, verts)
        kps = kps_full.index_select(1, self._kps_keep)
        z, z_kps, dummy = self.model.encode(self.params, x, kps)
        return {"z": z, "z_kps": z_kps, "dummy": dummy,
                "kps_full": kps_full}

    @torch.inference_mode()
    def decode(self, z, z_kps, dummy=None) -> np.ndarray:
        """-> verts [B, V, 3].  dummy=None uses zeros (the demo's choice,
        demo.py:96-103)."""
        z, z_kps = self._in(z), self._in(z_kps)
        if dummy is None:
            dummy = z.new_zeros((z.shape[0], 1, self.model.enc_out_c))
        rec = self.model.decode(self.params, z, z_kps, self._in(dummy))
        return rec[:, :-1].cpu().numpy()

    @torch.inference_mode()
    def decode_with_kps(self, z, kps_kept, dummy=None) -> np.ndarray:
        """Decode with pose taken from explicit kept keypoints [B, 32, 3]."""
        z_kps = self.model.kps_encode(self.params, self._in(kps_kept))
        return self.decode(z, z_kps, dummy)

    def reconstruct(self, verts) -> np.ndarray:
        lat = self.encode(verts)
        return self.decode(lat["z"], lat["z_kps"], lat["dummy"])

    # --- the four reference edits --------------------------------------------
    @torch.inference_mode()
    def edit_orientation(self, verts, donor_verts, bones) -> np.ndarray:
        """Transplant the chosen bones' orientations from donor meshes."""
        lat, dlat = self.encode(verts), self.encode(donor_verts)
        skl = kps2skl(lat["kps_full"], "ori_m")
        donor = kps2skl(dlat["kps_full"], "ori_m")
        new_kps = skl2kps(E.transplant_orientation(skl, donor, bones))
        return self.decode_with_kps(lat["z"], new_kps)

    @torch.inference_mode()
    def edit_bone_length(self, verts, bones, factor) -> np.ndarray:
        """Scale the chosen bones' lengths (demo: x1.2 on the arm chain)."""
        lat = self.encode(verts)
        skl = kps2skl(lat["kps_full"], "ori_m")
        new_kps = skl2kps(E.scale_bone_length(skl, bones, factor))
        return self.decode_with_kps(lat["z"], new_kps)

    @torch.inference_mode()
    def edit_girth(self, verts, parts, factor) -> np.ndarray:
        """Scale the chosen parts' girth (demo: chest/abdomen/hip x1.2)."""
        lat = self.encode(verts)
        return self.decode(E.scale_girth(lat["z"], parts, factor),
                           lat["z_kps"])

    @torch.inference_mode()
    def style_transfer(self, verts, donor_verts, parts=None) -> np.ndarray:
        """Donor's shape style at the source's body measures."""
        lat, dlat = self.encode(verts), self.encode(donor_verts)
        return self.decode(E.style_transfer_z(lat["z"], dlat["z"], parts),
                           lat["z_kps"])

    @torch.inference_mode()
    def interpolate(self, verts_a, verts_b, ts) -> np.ndarray:
        """[T, B, V, 3] latent interpolation sequence (shape AND pose)."""
        a, b = self.encode(verts_a), self.encode(verts_b)
        return np.stack([
            self.decode(E.interpolate_z(a["z"], b["z"], t),
                        E.interpolate_z(a["z_kps"], b["z_kps"], t))
            for t in np.atleast_1d(ts)])

    @torch.inference_mode()
    def measure(self, verts) -> np.ndarray:
        """[B, 32] body measures (16 girths + 16 bone lengths) on the device,
        to check an edit's physical effect (utils_SH.py:144-161)."""
        from ..ops.measure import measure_body, pack_girth_tables
        if self._girth_tables is None:
            idx, fac, _mask = pack_girth_tables(self.assets.girth_edges,
                                                self.assets.girth_factors)
            self._girth_tables = (
                torch.as_tensor(idx, device=self.device),
                torch.as_tensor(fac, device=self.device))
        idx, fac = self._girth_tables
        return measure_body(self._in(verts), self._jreg, idx, fac,
                            MEASURE_SKL_LIST).cpu().numpy()

    # --- export --------------------------------------------------------------
    def part_colors(self) -> np.ndarray:
        """[V, 3] per-vertex part colour map (main.py:132-158)."""
        from ..data.assets import part_color_map
        return part_color_map(self.assets.part_dict,
                              self.assets.template_verts.shape[0])

    def export_obj(self, path: str, verts: np.ndarray,
                   with_part_colors: bool = False,
                   with_skeleton: bool = False) -> str:
        """Write one mesh [V, 3]; optional part colours + skeleton strip."""
        kps = None
        if with_skeleton:
            kps = (np.asarray(self.assets.j_regressor, np.float32)
                   @ np.asarray(verts, np.float32))
        save_obj(path, verts, self.assets.template_faces,
                 vert_colors=self.part_colors() if with_part_colors else None,
                 skl_list=NEWSKL_LIST if with_skeleton else None,
                 kps=kps)
        return path


def run_demo(editor: Editor, verts: np.ndarray, out_dir: str,
             donor_shift: int = 1) -> dict:
    """The reference demo script as a function: run all four edits on a batch
    and dump OBJs (demo.py:75-114).  Returns {edit_name: verts array}."""
    os.makedirs(out_dir, exist_ok=True)
    donor = np.roll(verts, donor_shift, axis=0)
    arm_bones = [14, 15, 16, 17]               # shoulder+elbow chains
    girth_parts = ["chest", "abdomen", "hip"]
    results = {
        "rec": editor.reconstruct(verts),
        "ori": editor.edit_orientation(verts, donor, arm_bones),
        "bonelen": editor.edit_bone_length(verts, arm_bones, 1.2),
        "girth": editor.edit_girth(verts, girth_parts, 1.2),
        "style": editor.style_transfer(verts, donor),
    }
    for name, v in results.items():
        editor.export_obj(os.path.join(out_dir, f"sample0_{name}.obj"),
                          v[0], with_part_colors=True, with_skeleton=True)
    return results
