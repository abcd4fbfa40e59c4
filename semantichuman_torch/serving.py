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
records per artifact as `platforms` (with the card's index: "cuda:0"; a
manifest that names the type alone still loads).  A bundle refuses a
device of another type; on another card of the same type each program is
moved there (`torch.export.passes.move_to_device_pass`), and the load
checks that no tensor of a moved program is left off its device.

`ServingBundle(dir, device=[d0, d1, ...])` serves one batch over several
devices, the counterpart of the JAX bundle called on a batch-sharded
input: one copy of each program per listed device, loaded (and moved)
from the same `.pt2` files, never exported again.  A call splits the
batch into contiguous equal shards in device order (a batch the device
count does not divide raises, as JAX's `NamedSharding` refuses it),
launches every shard before it reads any result, and returns a `Shards`:
each shard's outputs stay on its copy's device, and `Shards.gather()`
concatenates them onto one.  A device may be listed twice (two copies on
one card).  One device behaves as a bundle of one: the call returns the
outputs themselves.

On the card, the first call of a copy's program at a batch b <=
`_GRAPH_MAX_B` warms it up on a side stream and captures it into a CUDA
graph with static input and output buffers, keyed by (artifact, b), each
copy with its own graphs and memory pool; later calls copy the input in,
replay, and return clones of the outputs.  Capture and replay run with the
copy's card current, so a copy on another card than the process's current
one captures its own launches.  This is the counterpart of the JAX
loader's `jax.jit(exp.call)` cache: a forward at small batch is paced by
the host's launches, and a replay has none.  Larger batches and the CPU
call the program eagerly.  The graphs are `train/graph.py`'s, named
`serve/<artifact>/<b>` (and `/<device index>` where the bundle has several
copies), so their launches count once a replay (`ops/launches.py`).  In a
profiler's trace a call shows its phases as program spans
(`utils/profiling.py:span`): `sh:serve.input` (each argument copied onto
the device), `sh:serve.copy_in` (into the static inputs),
`sh:replay/<graph>`, `sh:serve.clone` (the outputs), or `sh:serve.eager`
(the program called eagerly), and `sh:capture/<graph>` where a call
builds a graph.

The rebuilt live model stays on the bundle (`model`, `params`, `live`), on
the first listed device: an exported program fixes the banded gates'
route when it is traced, and the live model follows the gates at call
time.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from types import SimpleNamespace

import numpy as np
import torch
import torch.export.passes
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
from .utils.profiling import span

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
            "platforms": [str(t.device)],
            "in_shapes": [list(s) for s in shapes[name]],
        }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _indexed(device: torch.device) -> torch.device:
    """A card without an index as the current one ("cuda" -> "cuda:0")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device: torch.device):
    """`device` made the current card for the block (nothing on the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def off_device(ep, device) -> list:
    """What in the ExportedProgram `ep` is not on `device`: its state and
    constants, each node's device argument and the tensors of its traced
    metadata, as (what, device) pairs."""
    device = torch.device(device)
    out = [(k, v.device) for k, v in (*ep.state_dict.items(),
                                      *ep.constants.items())
           if torch.is_tensor(v) and v.device != device]
    for node in ep.graph.nodes:
        dev = node.kwargs.get("device")
        if dev is not None and torch.device(dev) != device:
            out.append((f"{node.name} device=", torch.device(dev)))
        vals = node.meta.get("val")
        for v in vals if isinstance(vals, (list, tuple)) else (vals,):
            if torch.is_tensor(v) and v.device != device:
                out.append((f"{node.name} value", v.device))
    return out


def load_program(path: str, device):
    """The ExportedProgram at `path` with every tensor on `device`: moved
    there where the export left any elsewhere (another card)."""
    device = torch.device(device)
    ep = torch.export.load(path)
    if off_device(ep, device):
        ep = torch.export.passes.move_to_device_pass(ep, str(device))
        left = off_device(ep, device)
        if left:
            raise RuntimeError(f"{path}: moved to {device}, but {left[:4]} "
                               f"(of {len(left)}) stayed off it")
    return ep


class Shards(list):
    """A call's outputs over several devices: one entry per copy, in device
    order, each what the one-device call returns (a tensor or a tuple of
    tensors) for its shard of the batch, on its copy's device."""

    def gather(self, device=None):
        """The shards concatenated along the batch onto `device` (default:
        the first shard's): what the one-device bundle returns."""
        first = self[0]
        if torch.is_tensor(first):
            dev = first.device if device is None else device
            return torch.cat([s.to(dev) for s in self])
        dev = first[0].device if device is None else device
        return tuple(torch.cat([s[i].to(dev) for s in self])
                     for i in range(len(first)))


class _Copy:
    """One device's copy of the bundle's programs, with its own captured
    graphs (by (artifact, batch)) and their memory pool; `tag` ends its
    graphs' names."""

    def __init__(self, bundle_dir: str, artifacts: dict, device,
                 tag: str = ""):
        self.device = device
        self.tag = tag
        self.programs = {
            name: load_program(os.path.join(bundle_dir, meta["file"]),
                               device).module()
            for name, meta in artifacts.items()}
        self.captured: dict = {}
        self.pool = None

    def input(self, a) -> torch.Tensor:
        with span("serve.input"):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=self.device)

    def call(self, name: str, args: tuple, graph: bool | None):
        if graph is None:
            graph = (self.device.type == "cuda"
                     and args[0].shape[0] <= _GRAPH_MAX_B)
        if not graph:
            with span("serve.eager"), torch.inference_mode(), \
                    _on(self.device):
                return self.programs[name](*args)
        key = (name, args[0].shape[0])
        if key not in self.captured:
            self.captured[key] = self.capture(name, args)
        cuda_graph, inputs, outputs = self.captured[key]
        with _on(self.device):
            with span("serve.copy_in"):
                for static, a in zip(inputs, args):
                    static.copy_(a)
            cuda_graph.replay()
            with span("serve.clone"):
                if isinstance(outputs, torch.Tensor):
                    return outputs.clone()
                return tuple(o.clone() for o in outputs)

    def capture(self, name: str, args) -> tuple:
        """Warm the program up on a side stream, then capture it into the
        graph `serve/<name>/<b><tag>` over static copies of `args` (one
        memory pool for all of the copy's graphs), all with the copy's card
        current: (graph, static inputs, static outputs)."""
        from .train import graph as G

        prog = self.programs[name]
        gname = f"serve/{name}/{args[0].shape[0]}{self.tag}"
        with torch.cuda.device(self.device):
            inputs = tuple(a.clone() for a in args)

            def run():
                with torch.no_grad():
                    return prog(*inputs)

            G.warm_up(run, lambda: None, gname)
            graph = G.capture(run, self.pool, gname)
        self.pool = graph.pool()
        return graph, inputs, graph.out


class ServingBundle:
    """Load an exported bundle onto `device`, or one copy of its programs
    onto each device of a list; `forward`, `encode` and `decode` take
    arrays or tensors and return float32 tensors on that device (a list:
    a `Shards` of them, one per device)."""

    def __init__(self, bundle_dir: str, device="cuda"):
        listed = device if isinstance(device, (list, tuple)) else [device]
        if not listed:
            raise ValueError("ServingBundle needs at least one device")
        devices = [resolve_device(d) for d in listed]
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        for name, meta in self.manifest["artifacts"].items():
            types = {torch.device(p).type for p in meta["platforms"]}
            for dev in devices:
                if dev.type not in types:
                    raise ValueError(
                        f"{bundle_dir}: artifact {name!r} was exported on "
                        f"{meta['platforms']}, so it cannot serve on "
                        f"{dev.type!r}: export the bundle again on that "
                        "device")
        self.devices = [_indexed(d) for d in devices]
        self.device = self.devices[0]
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
        self._copies = [
            _Copy(bundle_dir, self.manifest["artifacts"], dev,
                  f"/{dev.index}" if len(self.devices) > 1 else "")
            for dev in self.devices]
        self._programs = self._copies[0].programs
        self._captured = self._copies[0].captured

    def _in(self, a) -> torch.Tensor:
        return self._copies[0].input(a)

    # --- the exported programs ---------------------------------------------
    def call(self, name: str, *args, graph: bool | None = None):
        """Run artifact `name`: from its captured graph where `graph` (by
        default: on the card at b <= _GRAPH_MAX_B), else the program
        eagerly.  Over several devices, each copy runs its contiguous
        shard of the batch, every shard launched before any result is
        read: -> Shards, each shard's outputs on its copy's device."""
        if len(self._copies) == 1:
            copy = self._copies[0]
            return copy.call(name, tuple(copy.input(a) for a in args), graph)
        n, b = len(self._copies), len(args[0])
        if b % n:
            raise ValueError(f"a batch of {b} does not split into equal "
                             f"shards over {n} devices")
        k = b // n
        shards = [tuple(c.input(a[i * k:(i + 1) * k]) for a in args)
                  for i, c in enumerate(self._copies)]
        return Shards(c.call(name, s, graph)
                      for c, s in zip(self._copies, shards))

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
