"""8-fold dihedral symmetry of square boards, as gather permutations.

The reference augments each (state, π) with 4 rotations × mirror before
pushing to the buffer (SURVEY.md §2 "Replay buffer", `get_equi_data`).
The change here: augmentation is a *sample-time* jit transform — one gather
with a precomputed permutation per symmetry element, applied to the flat
board and π identically (both are fields over cells), so the buffer stores
each position once (8× less memory) and the learner sees a fresh random
symmetry every epoch.

Tables are built host-side once per board size:
  perm[k, i]  = flat source cell for destination cell i under symmetry k
  inv[k, j]   = destination cell of source cell j (for last-move indices)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

NUM_SYMMETRIES = 8


@functools.lru_cache(maxsize=None)
def dihedral_tables(size: int) -> Tuple[np.ndarray, np.ndarray]:
    base = np.arange(size * size).reshape(size, size)
    perms = []
    for flip in (False, True):
        m = np.fliplr(base) if flip else base
        for rot in range(4):
            perms.append(np.rot90(m, rot).reshape(-1))
    perm = np.stack(perms).astype(np.int32)          # [8, A]
    inv = np.empty_like(perm)
    ar = np.arange(size * size)
    for k in range(NUM_SYMMETRIES):
        inv[k, perm[k]] = ar
    return perm, inv


def apply_symmetry(size: int, k: jnp.ndarray, field: jnp.ndarray
                   ) -> jnp.ndarray:
    """Permute per-cell field[B, A] by symmetry k[B] (gather, jit-friendly)."""
    perm, _ = dihedral_tables(size)
    return jnp.take_along_axis(field, jnp.asarray(perm)[k], axis=1)


def apply_symmetry_index(size: int, k: jnp.ndarray, idx: jnp.ndarray
                         ) -> jnp.ndarray:
    """Map flat cell indices idx[B] (−1 passes through) under symmetry k[B]."""
    _, inv = dihedral_tables(size)
    mapped = jnp.asarray(inv)[k, jnp.maximum(idx, 0)]
    return jnp.where(idx < 0, idx, mapped)
