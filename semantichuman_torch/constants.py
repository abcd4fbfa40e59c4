"""Skeleton / body-part constant tables for the SMPL-topology human model.

The port's own copy of the subset of `semantichuman_tpu/constants.py` that
the serving and training paths need (the two packages share no code).

Joint convention: 24 SMPL joints + 11 extra leaf keypoints = 35 keypoints
regressed by J_regressor [35, V].  `KPS_DROP` = {3, 13, 14} are redundant
spine/collar joints dropped from model inputs, leaving 32 "kept" keypoints.
"""

from __future__ import annotations

import numpy as np

# 31 bones as (entry0, entry1) pairs of 35-keypoint indices; a bone vector is
# kps[entry0] - kps[entry1] (traincfg.yaml CONSTANTS.newskl_list)
NEWSKL_LIST: list[list[int]] = [
    [0, 1], [0, 2], [0, 6], [1, 4], [2, 5], [6, 9], [4, 7], [5, 8],
    [9, 12], [9, 16], [9, 17], [7, 10], [8, 11], [12, 15], [16, 18],
    [17, 19], [18, 20], [19, 21], [20, 22], [21, 23], [20, 24], [21, 25],
    [20, 26], [21, 27], [15, 28], [15, 29], [15, 30], [7, 31], [8, 32],
    [7, 33], [8, 34],
]

N_KPS_FULL = len(NEWSKL_LIST) + 4  # 35
KPS_DROP = [3, 13, 14]
KPS_KEEP = [i for i in range(N_KPS_FULL) if i not in KPS_DROP]  # 32 kept

# Per-part bone used for measurements / orientation weights (17 entries, one
# per part in PART_LIST order).  Entries with 3 indices use the midpoint of
# the last two as the far endpoint.
SKL_LIST: list[list[int]] = [
    [15, 12], [15, 12], [12, 9], [6, 0], [0, 1, 2], [1, 4],
    [4, 7], [7, 10], [2, 5], [5, 8], [8, 11], [16, 18],
    [18, 20], [20, 22], [17, 19], [19, 21], [21, 23],
]

# Bones whose length may be edited (SKL_KEEP) and whose orientation may be
# exchanged (NEWSKL_KEEP)
SKL_KEEP = [0, 1, 2, 3, 4, 6, 7, 8, 13, 14, 15, 16, 17]
NEWSKL_KEEP = [i for i in range(len(NEWSKL_LIST)) if i not in (5, 9, 10)]

# Bones of the 16 skeleton-length entries of the 32-d body-measure vector
MEASURE_SKL_LIST: list[list[int]] = SKL_LIST[1:]

# SKL_LIST without its repeated first bone and the four bones that end at
# a hand or a foot (the reference's noleaf_skl_list); no path reads it.
NOLEAF_SKL_LIST: list[list[int]] = [
    [15, 12], [12, 9], [6, 0], [0, 1, 2], [1, 4],
    [4, 7], [2, 5], [5, 8], [16, 18], [18, 20], [17, 19], [19, 21],
]

# Per-part keypoint groups feeding the per-part pose encoders, in the *kept*
# 32-keypoint space (traincfg.yaml CONSTANTS.kps_index_list).
KPS_INDEX_LIST: list[list[int]] = [
    [12, 25, 26, 27], [12, 11], [11, 8], [5, 0], [0, 1, 2], [1, 3],
    [3, 6], [6, 9, 28, 30], [2, 4], [4, 7], [7, 10, 29, 31], [13, 15],
    [15, 17], [17, 19, 21, 23], [14, 16], [16, 18], [18, 20, 22, 24],
]

PART_LIST = [
    "head", "neck", "chest", "abdomen", "hip", "left_ham", "left_shank",
    "left_feet", "right_ham", "right_shank", "right_feet", "left_arm",
    "left_forearm", "left_hand", "right_arm", "right_forearm", "right_hand",
]
N_PARTS = len(PART_LIST)  # 17

LEAF_PART_LIST = ["head", "left_feet", "right_feet", "left_hand", "right_hand"]
NOLEAF_PART_LIST = [p for p in PART_LIST if p not in LEAF_PART_LIST]  # 12

MEASURE_PART_LIST = [
    "neck", "chest", "abdomen", "hip", "left_ham", "left_shank",
    "left_feet", "right_ham", "right_shank", "right_feet", "left_arm",
    "left_forearm", "left_hand", "right_arm", "right_forearm", "right_hand",
]

LEAF_PART_INDICES = [PART_LIST.index(p) for p in LEAF_PART_LIST]  # [0,7,10,13,16]
NOLEAF_PART_INDICES = [PART_LIST.index(p) for p in NOLEAF_PART_LIST]
NOLEAF_IN_MEASURE = [MEASURE_PART_LIST.index(p) for p in NOLEAF_PART_LIST]

# SMPL kinematic tree over the 24 base joints
PARENT_DICT = {
    1: 0, 2: 0, 3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7,
    11: 8, 12: 9, 13: 9, 14: 9, 15: 12, 16: 13, 17: 14, 18: 16, 19: 17,
    20: 18, 21: 19, 22: 20, 23: 21,
}
CHILD_DICT = {
    0: [1, 2, 3], 1: [4], 2: [5], 3: [6], 4: [7], 5: [8], 6: [9], 7: [10],
    8: [11], 9: [12, 13, 14], 12: [15], 13: [16], 14: [17], 16: [18],
    17: [19], 18: [20], 19: [21], 20: [22], 21: [23],
}


PARTCOLOR_LIST = [
    [0, 191, 255], [255, 0, 191], [255, 0, 63], [0, 127, 255],
    [255, 0, 254], [0, 254, 255], [255, 0, 127], [255, 127, 0],
    [0, 0, 255], [255, 191, 0], [63, 0, 255], [191, 255, 0],
    [0, 255, 0], [0, 63, 255], [127, 255, 0], [127, 0, 255],
    [255, 63, 0], [191, 0, 255], [0, 255, 63], [254, 255, 0],
    [63, 255, 0], [255, 0, 0], [0, 255, 191], [0, 255, 127],
]

def bone_endpoint_arrays(skl_list: list[list[int]]):
    """(idx_a, idx_b1, idx_b2) int32 arrays; the far endpoint of bone k is
    (kps[idx_b1[k]] + kps[idx_b2[k]]) / 2, which equals kps[idx_b1[k]] when
    the bone has two entries (idx_b2 == idx_b1)."""
    a = np.array([b[0] for b in skl_list], dtype=np.int32)
    b1 = np.array([b[1] for b in skl_list], dtype=np.int32)
    b2 = np.array([b[2] if len(b) == 3 else b[1] for b in skl_list],
                  dtype=np.int32)
    return a, b1, b2


def skl_path_matrix(skl_list: list[list[int]] = NEWSKL_LIST) -> np.ndarray:
    """[n_kps_full, n_bones] binary matrix P with P[j, k] = 1 iff bone k lies
    on the path from the root (joint 0) to joint j, so that skeleton ->
    keypoint integration is one matmul: kps = -(P @ (dir * len)).  Assumes
    skl_list is topologically ordered (parents first), as NEWSKL_LIST is."""
    paths = np.zeros((N_KPS_FULL, len(skl_list)), dtype=np.float32)
    for k, bone in enumerate(skl_list):
        src, dst = bone[0], bone[1]
        paths[dst] = paths[src]
        paths[dst, k] += 1.0
    return paths
