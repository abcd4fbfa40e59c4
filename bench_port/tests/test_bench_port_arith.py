"""The yardstick's arithmetic against the Bound column of the port's kernel
table (PERF.md, Findings): the nine f32 convs at B = 64 and 384 (row 1),
their backward at 384, the step's six row gathers (row 7) and the 17 CSR
reduces of a B = 128 step (row 8), all at SMPL scale from the bundled
hierarchy; and the model FLOP count against a hand count."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from bench_port import arith as A
from bench_port.reference.constants import KPS_KEEP, NOLEAF_PART_INDICES
from bench_port.reference.model import conv_plan
from bench_port.synth import Human

ROOT = Path(__file__).resolve().parents[2]
ENC = [[3, 16, 32, 64, 128], [[], [], [], [], []]]
DEC = [[128, 64, 32, 32, 16], [[], [], [], [], 3]]


@pytest.fixture(scope="module")
def topo():
    with np.load(ROOT / "assets" / "topology_synth_full_2222.npz") as z:
        return {k: z[k] for k in z.files}


def _convs(topo):
    sizes = [len(topo[f"verts_{l}"]) for l in range(5)]
    spirals = [topo[f"spirals_{l}"].shape[1] for l in range(5)]
    plan = conv_plan(ENC, 5, False) + conv_plan(DEC, 5, True)
    return [(sizes[l] + 1, spirals[l], ci, co) for l, ci, co, _ in plan]


@pytest.mark.parametrize("b, want", [(64, 0.557), (384, 3.339)])
def test_row1_forward_bound(topo, b, want):
    got = sum(max(A.conv_fwd_bound(b, *c)) for c in _convs(topo))
    assert round(got, 3) == want


def test_row1_backward_bound(topo):
    got = sum(max(A.conv_bwd_bound(384, *c)) for c in _convs(topo))
    assert round(got, 3) == 6.678


def test_row7_gather_bound(topo):
    """Four unpools and the level-0 pool at trunk 384, the edgereg faces
    on 128 reconstructions."""
    dec = conv_plan(DEC, 5, True)
    got = sum(A.gather_bound_ms(topo[f"unpool_idx_{lvl}"], 384,
                                next(ci for lv, ci, _, _ in dec if lv == lvl),
                                weighted=True) for lvl in range(4))
    got += A.gather_bound_ms(topo["pool_idx_0"], 384, 16)
    got += A.gather_bound_ms(Human().template_faces.reshape(-1), 128, 3)
    assert round(got, 4) == 0.4523


def test_row8_csr_bound(topo):
    """The 17 reduces of one B = 128 step (trunk 384): the unfused dx of
    the 64 -> 128 conv, the backwards of the four pools, the part gather
    and the four unpools, and of the loss's seven gathers on the
    reconstructions or z (edgereg and volume faces, the non-leaf |z|, two
    keypoint terms, the distance loss's part bucket in two calls)."""
    sizes = [len(topo[f"verts_{l}"]) for l in range(5)]
    h = Human()
    sp = topo["spirals_3"]
    got = A.csr_bound_ms(sp.shape[0], np.arange(sp.size), 384, 64)
    for lvl, c in enumerate((16, 32, 64, 128)):
        got += A.gather_backward_ms(topo[f"pool_idx_{lvl}"], sizes[lvl] + 1,
                                    384, c)
    coarse = [np.isin(topo["coarse_to_fine"], f).sum()
              for f in h.part_dict.values()]
    got += A.gather_backward_ms(np.zeros(17 * max(coarse)), sizes[4] + 1,
                                384, 128)
    for lvl, c in zip((3, 2, 1, 0), (128, 64, 32, 32)):
        got += A.gather_backward_ms(topo[f"unpool_idx_{lvl}"],
                                    sizes[lvl + 1] + 1, 384, c, weighted=True)
    faces = h.template_faces.reshape(-1)
    got += 2 * A.gather_backward_ms(faces, sizes[0], 128, 3)
    got += A.gather_backward_ms(np.array(NOLEAF_PART_INDICES), 17, 128, 1)
    got += 2 * A.gather_backward_ms(np.array(KPS_KEEP), 35, 128, 3)
    n_src = 1 + max(int(p.max()) for p in h.part_dict.values())
    got += 2 * A.gather_backward_ms(np.zeros(17 * 408), n_src, 128, 3)
    assert round(got, 4) == 1.0705


def test_model_flops_hand_count():
    """Two levels of 3 and 2 vertices, spirals of 4 and 2, one conv each
    way (3 -> 5 at level 0; 5 -> 3 at level 0), heads 2 x (10 -> 4) and
    (4 -> 10), at b = 2."""
    shape = {"enc_plan": [(0, 3, 5, "elu")], "dec_plan": [(0, 5, 3, "id")],
             "sizes": [3, 2], "spiral_sizes": [4, 2],
             "enc_dense": [(10, 4, 2)], "dec_dense": [(4, 10, 1)]}
    enc = 2 * 2 * 4 * 4 * 3 * 5 + 2 * 2 * 10 * 4 * 2     # 960 + 320
    dec = 2 * 2 * 4 * 4 * 5 * 3 + 2 * 2 * 4 * 10         # 960 + 160
    assert A.model_flops(shape, 2, "encode") == enc
    assert A.model_flops(shape, 2, "decode") == dec
    assert A.train_step_flops(shape, 2) == 3 * (enc + dec)
