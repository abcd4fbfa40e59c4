"""Serving: exported inference bundles (counterpart of
`semantichuman_tpu/serving.py`).

A bundle is a directory with `manifest.json`, one `torch.export` program
per function (`forward.pt2`, `encode.pt2`, `decode.pt2`: the parameters,
the topology tables, the joint regressor and KPS_KEEP baked in) and one
`torch.save` payload (`bundle.pt`) that rebuilds the live model.  The
programs have the JAX artifacts' signatures and shapes:

  forward  (verts [B, V+1, 3])          -> (rec [B, V+1, 3], z, z_kps)
  encode   (verts [B, V+1, 3])          -> (z, z_kps, dummy)
  decode   (z, z_kps [B, P, nz|nk])     -> verts [B, V, 3]

By default the batch dimension is exported symbolic (`torch.export.Dim`,
min 1): one program serves every batch size.  Where the model does not
trace symbolically, the export falls back to the fixed `batch_size`, with
a warning and `symbolic_batch: false` in the manifest, as the JAX export
does.  The conv forward and the row gather enter the programs as the
custom ops `semantichuman::spiral_conv_fwd` and `semantichuman::
gather_rows` (`ops/spiral_conv.py`, `ops/row_gather.py`), so a `.pt2`
file loads only where `semantichuman_torch` is imported.  The programs'
constants live on the device they were exported on, which the manifest
records per artifact as `platforms`; a bundle refuses another device.

On the card, the first call of a program at a batch b <= `_GRAPH_MAX_B`
warms it up on a side stream and captures it into a CUDA graph with static
input and output buffers, keyed by (artifact, b); later calls copy the
input in, replay, and return clones of the outputs.  This is the
counterpart of the JAX loader's `jax.jit(exp.call)` cache: a forward at
small batch is paced by the host's launches, and a replay has none.
Larger batches and the CPU call the program eagerly.

The rebuilt live model stays on the bundle (`model`, `params`, `live`):
an exported program fixes the banded gates' route when it is traced, and
the live model follows the gates at call time.
"""

from __future__ import annotations

import json
import os
import warnings
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from .constants import KPS_KEEP
from .models.factory import TRUNK_DTYPES
from .models.part_ae import PartAE
from .models.tables import device_tables
# the programs call the two custom ops: importing these modules registers
# them before a program is loaded
from .ops import row_gather, spiral_conv  # noqa: F401
from .utils.device import resolve_device
from .utils.params import tree_leaves, tree_map, tree_unflatten

PAYLOAD = "bundle.pt"
# the example batch of a symbolic export: torch.export specialises a
# dimension whose example is 0 or 1
_EXAMPLE_B = 2
# the largest batch served from a captured CUDA graph, set from
# `chip_smoke.py` phase 10's measurement (`graph_gate`: the eager program
# and the graph in turns at B = 1, 16 and 64, the graph faster at all
# three on an H100; PERF.md section 5).  Larger batches are not measured.
_GRAPH_MAX_B = 64


class _Program(nn.Module):
    """One exported function: the model, its parameters as buffers, the
    joint regressor and KPS_KEEP."""

    def __init__(self, model: PartAE, params: dict, j_regressor):
        super().__init__()
        self.model = model
        self._like = tree_map(lambda _: None, params)
        leaves = tree_leaves(params)
        self._n = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"p{i}", leaf.detach())
        dev = model.tables.device
        self.register_buffer("jreg", torch.as_tensor(
            np.asarray(j_regressor, np.float32), device=dev))
        self.register_buffer("keep", torch.as_tensor(KPS_KEEP, device=dev))

    def params(self) -> dict:
        return tree_unflatten(self._like,
                              [getattr(self, f"p{i}") for i in range(self._n)])

    def regress(self, verts):
        kps_full = torch.einsum("jv,bvc->bjc", self.jreg, verts[:, :-1])
        return kps_full.index_select(1, self.keep)


class ForwardProgram(_Program):
    def forward(self, verts):
        return self.model(self.params(), verts, self.regress(verts))


class EncodeProgram(_Program):
    def forward(self, verts):
        return self.model.encode(self.params(), verts, self.regress(verts))


class DecodeProgram(_Program):
    def forward(self, z, z_kps):
        dummy = z.new_zeros((z.shape[0], 1, self.model.enc_out_c))
        return self.model.decode(self.params(), z, z_kps, dummy)[:, :-1]


_PROGRAMS = {"forward": ForwardProgram, "encode": EncodeProgram,
             "decode": DecodeProgram}


def _in_shapes(model: PartAE, b) -> dict:
    v1 = model.tables.sizes[0] + 1
    p, nz, nk = model.n_parts, model.latent_size, model.kps_latent_size
    return {"forward": [(b, v1, 3)], "encode": [(b, v1, 3)],
            "decode": [(b, p, nz), (b, p, nk)]}


def _export_all(model, params, j_regressor, b: int, symbolic: bool) -> dict:
    """{name: ExportedProgram} at example batch b, the batch a `Dim` when
    symbolic."""
    dev = model.tables.device
    bdim = torch.export.Dim("b", min=1) if symbolic else None
    out = {}
    for name, shapes in _in_shapes(model, b).items():
        prog = _PROGRAMS[name](model, params, j_regressor)
        args = tuple(torch.zeros(s, dtype=torch.float32, device=dev)
                     for s in shapes)
        dyn = tuple({0: bdim} for _ in args) if symbolic else None
        with torch.no_grad():
            out[name] = torch.export.export(prog, args, dynamic_shapes=dyn)
    return out


def export_inference(model: PartAE, params: dict, j_regressor, out_dir: str,
                     batch_size: int = 1, symbolic_batch: bool = True) -> dict:
    """Write `model` with `params` as a bundle into out_dir: the three
    programs, traced on the model's device, and the payload.  Returns the
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

    progs, sym = None, False
    if symbolic_batch:
        try:
            progs = _export_all(model, params, j_regressor, _EXAMPLE_B, True)
            sym = True
        except Exception as e:
            warnings.warn(f"symbolic-batch export failed ({e!r}); falling "
                          f"back to fixed batch {batch_size}", stacklevel=2)
    if progs is None:
        progs = _export_all(model, params, j_regressor, batch_size, False)

    shapes = _in_shapes(model, "b" if sym else batch_size)
    manifest = {"batch_size": None if sym else batch_size,
                "symbolic_batch": sym, "n_vertices": t.sizes[0],
                "n_parts": model.n_parts, "nz": model.latent_size,
                "nk": model.kps_latent_size, "trunk_dtype": trunk_dtype,
                "banded_conv": t.banded_conv, "payload": PAYLOAD,
                "artifacts": {}}
    for name, ep in progs.items():
        torch.export.save(ep, os.path.join(out_dir, f"{name}.pt2"))
        manifest["artifacts"][name] = {
            "file": f"{name}.pt2",
            "platforms": [t.device.type],
            "in_shapes": [list(s) for s in shapes[name]],
        }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """Load an exported bundle onto `device`; `forward`, `encode` and
    `decode` take arrays or tensors and return float32 tensors on that
    device."""

    def __init__(self, bundle_dir: str, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        for name, meta in self.manifest["artifacts"].items():
            if self.device.type not in meta["platforms"]:
                raise ValueError(
                    f"{bundle_dir}: artifact {name!r} was exported on "
                    f"{meta['platforms']}, so it cannot serve on "
                    f"{self.device.type!r}: export the bundle again on "
                    "that device")
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
        self._live = {name: cls(self.model, self.params, pl["j_regressor"])
                      for name, cls in _PROGRAMS.items()}
        self._programs = {
            name: torch.export.load(
                os.path.join(bundle_dir, meta["file"])).module()
            for name, meta in self.manifest["artifacts"].items()}
        self._captured: dict = {}
        self._pool = None

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # --- the exported programs ---------------------------------------------
    def call(self, name: str, *args, graph: bool | None = None):
        """Run artifact `name`: from its captured graph where `graph` (by
        default: on the card at b <= _GRAPH_MAX_B), else the program
        eagerly."""
        args = tuple(self._in(a) for a in args)
        if graph is None:
            graph = (self.device.type == "cuda"
                     and args[0].shape[0] <= _GRAPH_MAX_B)
        if not graph:
            with torch.inference_mode():
                return self._programs[name](*args)
        key = (name, args[0].shape[0])
        if key not in self._captured:
            self._captured[key] = self._capture(name, args)
        cuda_graph, inputs, outputs = self._captured[key]
        for static, a in zip(inputs, args):
            static.copy_(a)
        cuda_graph.replay()
        if isinstance(outputs, torch.Tensor):
            return outputs.clone()
        return tuple(o.clone() for o in outputs)

    def _capture(self, name: str, args) -> tuple:
        """Warm the program up on a side stream, then capture it into a
        CUDA graph over static copies of `args` (one memory pool for all
        of the bundle's graphs): (graph, static inputs, static outputs)."""
        prog = self._programs[name]
        inputs = tuple(a.clone() for a in args)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(2):
                prog(*inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool):
            outputs = prog(*inputs)
        self._pool = graph.pool()
        return graph, inputs, outputs

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._programs:
            raise AttributeError(
                f"no artifact {name!r}; have {sorted(self._programs)}")
        return lambda *args: self.call(name, *args)

    # --- the live model, rebuilt from the payload ---------------------------
    @torch.inference_mode()
    def live(self, name: str, *args):
        """Artifact `name` computed by the live model (the modules the
        programs were exported from, run eagerly): the same function, its
        route chosen by the gates at call time."""
        if name not in self._live:
            raise AttributeError(
                f"no artifact {name!r}; have {sorted(self._live)}")
        return self._live[name](*(self._in(a) for a in args))
