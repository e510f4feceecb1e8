"""Canonical kinematic-tree parent tables for the SMPL model families.

A copy of `moshpp_tpu/models/kintree.py`: the JAX package's `models`
package imports JAX when it is imported, and this package never does.
Synthetic models use these tables so fullpose layouts match the real
families.
"""

SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)

# body (22) + 15 joints per hand (index, middle, pinky, ring, thumb x 3)
SMPLH_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
)

# body (22) + jaw, leye, reye + 15 joints per hand
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)

MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

# SMAL-family quadrupeds (synthetic defaults — real SMAL files carry their
# own kintree_table): pelvis -> spine chain, neck/head, four 4-joint legs,
# tail chain, ears/jaw off the head. Depth ~8 like the real rigs.
ANIMAL_HORSE_PARENTS = (
    -1,                      # 0  pelvis
    0, 1, 2, 3, 4,           # 1-5   spine
    5, 6,                    # 6-7   neck
    7,                       # 8     head
    5, 9, 10, 11,            # 9-12  left-front leg (9's parent: chest=5)
    5, 13, 14, 15,           # 13-16 right-front leg
    0, 17, 18, 19,           # 17-20 left-back leg
    0, 21, 22, 23,           # 21-24 right-back leg
    0, 25, 26, 27,           # 25-28 tail
    8, 8,                    # 29-30 ears
    8, 31,                   # 31-32 jaw chain
    8, 8, 32,                # 33-35 eyes + tongue
)
ANIMAL_DOG_PARENTS = (
    -1,
    0, 1, 2, 3,              # 1-4   spine
    4, 5,                    # 5-6   neck
    6,                       # 7     head
    4, 8, 9, 10,             # 8-11  left-front leg
    4, 12, 13, 14,           # 12-15 right-front leg
    0, 16, 17, 18,           # 16-19 left-back leg
    0, 20, 21, 22,           # 20-23 right-back leg
    0, 24, 25, 26,           # 24-27 tail
    7, 7,                    # 28-29 ears
    7, 30,                   # 30-31 jaw
    7, 7, 31,                # 32-34 eyes + tongue
)

DEFAULT_PARENTS = {
    "smpl": SMPL_PARENTS,
    "smplh": SMPLH_PARENTS,
    "smplx": SMPLX_PARENTS,
    "mano": MANO_PARENTS,
    "animal_horse": ANIMAL_HORSE_PARENTS,
    "animal_dog": ANIMAL_DOG_PARENTS,
}
