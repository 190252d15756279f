"""OGB molecular feature vocabulary spec shared by every model family.

A copy of ``flowgnn_tpu.core.features`` (numpy only). The reference hard-codes
these tables in each host program (GIN/src/host_load.cc:5-6) and the
categorical-offset tables in each kernel (GIN/src/load_inputs.cc:5,
GIN/src/message_passing.cc:3). They describe the 9 categorical atom features
and 3 categorical bond features of OGB molecular graphs (ogbg-molhiv /
ogbg-molpcba).
"""

from __future__ import annotations

import numpy as np

# Vocabulary size of each categorical atom feature (GIN/src/host_load.cc:5).
ATOM_FEATURE_DIMS: tuple[int, ...] = (119, 4, 12, 12, 10, 6, 6, 2, 2)

# Vocabulary size of each categorical bond feature (GIN/src/host_load.cc:6).
BOND_FEATURE_DIMS: tuple[int, ...] = (5, 6, 2)

NUM_ATOM_FEATURES = len(ATOM_FEATURE_DIMS)  # ND_FEATURE = 9
NUM_BOND_FEATURES = len(BOND_FEATURE_DIMS)  # EDGE_ATTR = 3

# Rows of the concatenated atom-embedding table (ND_FEATURE_TOTAL = 173).
ATOM_FEATURE_TOTAL = sum(ATOM_FEATURE_DIMS)

# Rows of the concatenated per-layer bond-embedding table
# (ED_FEATURE_PER_LAYER = 13).
BOND_FEATURE_TOTAL = sum(BOND_FEATURE_DIMS)

# Row offset of each feature's sub-table inside the concatenated table
# ({0,119,123,135,147,157,163,169,171} — GIN/src/load_inputs.cc:5).
ATOM_FEATURE_OFFSETS: np.ndarray = np.cumsum((0,) + ATOM_FEATURE_DIMS[:-1]).astype(
    np.int32
)

# ({0,5,11} — GIN/src/message_passing.cc:3).
BOND_FEATURE_OFFSETS: np.ndarray = np.cumsum((0,) + BOND_FEATURE_DIMS[:-1]).astype(
    np.int32
)

assert ATOM_FEATURE_TOTAL == 173
assert BOND_FEATURE_TOTAL == 13
assert list(ATOM_FEATURE_OFFSETS) == [0, 119, 123, 135, 147, 157, 163, 169, 171]
assert list(BOND_FEATURE_OFFSETS) == [0, 5, 11]
