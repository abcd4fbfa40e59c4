"""Serving: exported inference bundles (counterpart of
`semantichuman_tpu/serving.py`).

A bundle is a directory with `manifest.json` and one `torch.save` payload
holding the parameters, the topology tables, the part layout and the joint
regressor: everything needed to serve without the topology compiler or a
checkpoint.  The loaded bundle rebuilds its band tables under the same
`banded_conv` flag as the model it was exported from, and exposes the JAX
artifacts' functions with the same signatures and shapes, for any batch
size:

  forward  (verts [B, V+1, 3])          -> (rec [B, V+1, 3], z, z_kps)
  encode   (verts [B, V+1, 3])          -> (z, z_kps, dummy)
  decode   (z, z_kps [B, P, nz|nk])     -> verts [B, V, 3]
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from .constants import KPS_KEEP
from .models.factory import TRUNK_DTYPES
from .models.part_ae import PartAE
from .models.tables import device_tables
from .utils.device import resolve_device
from .utils.params import tree_map

PAYLOAD = "bundle.pt"


def export_inference(model: PartAE, params: dict, j_regressor,
                     out_dir: str) -> dict:
    """Write `model` with `params` as a bundle into out_dir.  Returns the
    manifest (also written to out_dir/manifest.json)."""
    os.makedirs(out_dir, exist_ok=True)
    t = model.tables
    trunk_dtype = {v: k for k, v in TRUNK_DTYPES.items()}[model.compute_dtype]
    payload = {
        "params": tree_map(lambda a: a.detach().cpu(), params),
        "tables": {
            "sizes": list(t.sizes),
            "spirals": [s.cpu() for s in t.spirals],
            "pool_idx": [p.cpu() for p in t.pool_idx],
            "unpool_idx": [u.cpu() for u in t.unpool_idx],
            "unpool_w": [w.cpu() for w in t.unpool_w],
        },
        "part_indices": {k: torch.from_numpy(v)
                         for k, v in model.part_indices.items()},
        "kps_index_list": model.kps_index_list,
        "filters_enc": model.filters_enc,
        "filters_dec": model.filters_dec,
        "nz": model.latent_size,
        "nk": model.kps_latent_size,
        "trunk_dtype": trunk_dtype,
        "banded_conv": t.banded_conv,
        "j_regressor": torch.as_tensor(np.asarray(j_regressor, np.float32)),
    }
    torch.save(payload, os.path.join(out_dir, PAYLOAD))
    v = t.sizes[0]
    p, nz, nk = model.n_parts, model.latent_size, model.kps_latent_size
    in_shapes = {"forward": [["b", v + 1, 3]], "encode": [["b", v + 1, 3]],
                 "decode": [["b", p, nz], ["b", p, nk]]}
    manifest = {"n_vertices": v, "n_parts": p, "nz": nz, "nk": nk,
                "trunk_dtype": trunk_dtype, "banded_conv": t.banded_conv,
                "artifacts": {name: {"file": PAYLOAD, "in_shapes": shapes}
                              for name, shapes in in_shapes.items()}}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """Load an exported bundle onto `device`; the callables take arrays or
    tensors and return float32 tensors on that device."""

    def __init__(self, bundle_dir: str, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        pl = torch.load(os.path.join(bundle_dir, PAYLOAD),
                        map_location="cpu", weights_only=True)
        tab = pl["tables"]
        hier = SimpleNamespace(
            sizes=tab["sizes"],
            **{k: [a.numpy() for a in tab[k]]
               for k in ("spirals", "pool_idx", "unpool_idx", "unpool_w")})
        self.model = PartAE(
            device_tables(hier, self.device,
                          banded=pl.get("banded_conv", False)),
            {k: v.numpy() for k, v in pl["part_indices"].items()},
            pl["kps_index_list"], pl["filters_enc"], pl["filters_dec"],
            latent_size=pl["nz"], part_kps_latent_size=pl["nk"],
            compute_dtype=TRUNK_DTYPES[pl["trunk_dtype"]])
        self.params = tree_map(lambda a: a.to(self.device), pl["params"])
        self._jreg = pl["j_regressor"].to(self.device)
        self._keep = torch.as_tensor(KPS_KEEP, device=self.device)
        self._fns = {"forward": self._forward, "encode": self._encode,
                     "decode": self._decode}

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _regress(self, verts):
        kps_full = torch.einsum("jv,bvc->bjc", self._jreg, verts[:, :-1])
        return kps_full.index_select(1, self._keep)

    @torch.inference_mode()
    def _forward(self, verts):
        verts = self._in(verts)
        return self.model(self.params, verts, self._regress(verts))

    @torch.inference_mode()
    def _encode(self, verts):
        verts = self._in(verts)
        return self.model.encode(self.params, verts, self._regress(verts))

    @torch.inference_mode()
    def _decode(self, z, z_kps):
        z, z_kps = self._in(z), self._in(z_kps)
        dummy = z.new_zeros((z.shape[0], 1, self.model.enc_out_c))
        return self.model.decode(self.params, z, z_kps, dummy)[:, :-1]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._fns[name]
        except KeyError:
            raise AttributeError(
                f"no artifact {name!r}; have {sorted(self._fns)}") from None
