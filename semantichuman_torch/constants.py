"""Skeleton / body-part constant tables for the SMPL-topology human model.

The port's own copy of the subset of `semantichuman_tpu/constants.py` that
the serving path needs (the two packages share no code).

Joint convention: 24 SMPL joints + 11 extra leaf keypoints = 35 keypoints
regressed by J_regressor [35, V].  `KPS_DROP` = {3, 13, 14} are redundant
spine/collar joints dropped from model inputs, leaving 32 "kept" keypoints.
"""

from __future__ import annotations

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
