"""What the drivers share: the cell's inputs from the seed, the model's
shapes for the arithmetic, and the reference built from the same files."""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..reference.constants import KPS_INDEX_LIST
from ..reference.model import PartAE as RefPartAE
from ..reference.model import SpiralAE as RefSpiralAE
from ..reference.model import Topology, conv_plan
from ..synth import Human

ROOT = Path(__file__).resolve().parents[2]


def topology_path(config: dict) -> Path:
    """The hierarchy file both sides read, relative to the checkout."""
    p = Path(config["topology"])
    return p if p.is_absolute() else ROOT / p


def workdir(name: str) -> str:
    """A fresh directory for the program's files under TMPDIR."""
    d = os.path.join(tempfile.gettempdir(), "bench_port", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def seed_topology(config: dict, wd: str) -> None:
    """Put the configuration's hierarchy file, with its compile key, where
    the Trainer reads its cached topology, so that a template other than
    the bundled one is not compiled again."""
    src = topology_path(config)
    tag = "".join(str(f) for f in config["model"]["ds_factors"])
    dst = os.path.join(wd, f"topology_{tag}.npz")
    shutil.copyfile(src, dst)
    if os.path.exists(str(src) + ".meta"):
        shutil.copyfile(str(src) + ".meta", dst + ".meta")


def human(config: dict) -> Human:
    return Human(**config.get("template", {}))


def model_shape(config: dict) -> dict:
    """The conv plans, level sizes and dense layers of the configuration,
    for `arith.model_flops`."""
    with np.load(topology_path(config), allow_pickle=False) as z:
        n = int(z["n_levels"])
        sizes = [len(z[f"verts_{l}"]) for l in range(n)]
        spirals = [z[f"spirals_{l}"].shape[1] for l in range(n)]
        c2f = z["coarse_to_fine"]
    m = config["model"]
    enc = conv_plan(m["filter_sizes_enc"], n, False)
    dec = conv_plan(m["filter_sizes_dec"], n, True)
    c_enc, c_dec = enc[-1][2], m["filter_sizes_dec"][0][0]
    if m["model_type"] == "neural3DMM":
        rows = sizes[-1] + 1
        enc_dense = [(rows * c_enc, m["nz"], 1)]
        dec_dense = [(m["nz"], rows * c_dec, 1)]
    else:
        h = human(config)
        n_max = max(int(np.isin(c2f, f).sum()) for f in h.part_dict.values())
        nz, nk, p = m["part_shape_latent_size"], m["part_kps_latent_size"], 17
        g_max = max(len(g) for g in KPS_INDEX_LIST)
        enc_dense = [(n_max * c_enc, nz, p), (g_max * 3, nk, p)]
        dec_dense = [(nz + nk, n_max * c_dec, p)]
    return {"enc_plan": enc, "dec_plan": dec, "sizes": sizes,
            "spiral_sizes": spirals, "enc_dense": enc_dense,
            "dec_dense": dec_dense}


def reference_model(config: dict, h: Human, device, dtype=torch.float32):
    topo = Topology.load(str(topology_path(config)), device)
    m = config["model"]
    if m["model_type"] == "neural3DMM":
        return RefSpiralAE(topo, m["filter_sizes_enc"], m["filter_sizes_dec"],
                           m["nz"], dtype)
    return RefPartAE(topo, h.part_dict, m["filter_sizes_enc"],
                     m["filter_sizes_dec"], dtype)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(like, flat) -> dict:
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [go(v) for v in t]
        return next(it)

    return go(like)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
