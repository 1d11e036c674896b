"""On-device ring replay buffer.

The reference uses a host-side `collections.deque` of pre-augmented
(state, π, z) tuples with `random.sample` minibatches (SURVEY.md §2 "Replay
buffer"). Redesign:

  * The buffer lives in device memory as fixed-capacity arrays inside the jitted
    actor-learner program — no host round-trips (SURVEY.md §7 hard part 3).
  * Entries store the *compact* position (int8 flat board, to-play, last-move,
    bf16 π, int8 z, validity) — features are re-encoded and the random
    dihedral symmetry applied at sample time (utils/symmetry.py), 8× less memory
    than the reference's pre-augmented tuples.
  * Writes are a wrap-around scatter at a running pointer; sampling is a
    uniform gather over the filled prefix. Capacity is sharded over the data
    mesh axis by the parallel layer (each shard is an independent ring).

`z_valid` marks positions whose game finished inside the collected chunk
(value target defined); π targets are always valid. The learner masks the
value loss accordingly (unbiased, no dynamic-shape filtering).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, ReplayConfig
from alphafive_tpu.utils import symmetry
from alphafive_tpu.utils import pytree


@pytree.dataclass
class ReplayBuffer:
    board: jnp.ndarray    # int8[C, A]
    to_play: jnp.ndarray  # int8[C]
    last_move: jnp.ndarray  # int32[C]
    pi: jnp.ndarray       # bfloat16[C, A]
    z: jnp.ndarray        # int8[C]
    z_valid: jnp.ndarray  # bool[C]
    pi_valid: jnp.ndarray  # bool[C] (π from a full-budget search)
    ptr: jnp.ndarray      # int32[] next write slot
    size: jnp.ndarray     # int32[] filled entries (<= C)


def init(env: EnvConfig, cfg: ReplayConfig,
         capacity: int | None = None) -> ReplayBuffer:
    c = capacity if capacity is not None else cfg.capacity
    a = env.num_actions
    return ReplayBuffer(
        board=jnp.zeros((c, a), jnp.int8),
        to_play=jnp.ones((c,), jnp.int8),
        last_move=jnp.full((c,), -1, jnp.int32),
        pi=jnp.zeros((c, a), jnp.bfloat16),
        z=jnp.zeros((c,), jnp.int8),
        z_valid=jnp.zeros((c,), bool),
        pi_valid=jnp.zeros((c,), bool),
        ptr=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


def write(buf: ReplayBuffer, board, to_play, last_move, pi, z,
          z_valid, pi_valid=None) -> ReplayBuffer:
    """Append M entries (leading axis M) with wrap-around. Requires M <= C."""
    c = buf.board.shape[0]
    m = board.shape[0]
    assert m <= c, f"chunk {m} larger than buffer {c}"
    idx = (buf.ptr + jnp.arange(m, dtype=jnp.int32)) % c
    if pi_valid is None:
        pi_valid = jnp.ones((m,), bool)
    return buf.replace(
        board=buf.board.at[idx].set(board.astype(jnp.int8)),
        to_play=buf.to_play.at[idx].set(to_play.astype(jnp.int8)),
        last_move=buf.last_move.at[idx].set(last_move.astype(jnp.int32)),
        pi=buf.pi.at[idx].set(pi.astype(jnp.bfloat16)),
        z=buf.z.at[idx].set(z.astype(jnp.int8)),
        z_valid=buf.z_valid.at[idx].set(z_valid),
        pi_valid=buf.pi_valid.at[idx].set(pi_valid),
        ptr=(buf.ptr + m) % c,
        size=jnp.minimum(buf.size + m, c),
    )


def sample(env: EnvConfig, buf: ReplayBuffer, key: jax.Array,
           batch_size: int) -> Tuple[jnp.ndarray, ...]:
    """Uniform minibatch with a fresh random dihedral symmetry per example.

    Returns (features[B,S,S,4] f32, pi[B,A] f32, z[B] f32, z_valid[B] f32,
    pi_valid[B] f32).
    """
    kidx, ksym = jax.random.split(key)
    idx = jax.random.randint(kidx, (batch_size,), 0,
                             jnp.maximum(buf.size, 1))
    sym = jax.random.randint(ksym, (batch_size,), 0,
                             symmetry.NUM_SYMMETRIES)
    s = env.board_size
    board = symmetry.apply_symmetry(
        s, sym, buf.board[idx].astype(jnp.int32)).astype(jnp.int8)
    pi = symmetry.apply_symmetry(s, sym, buf.pi[idx].astype(jnp.float32))
    last = symmetry.apply_symmetry_index(s, sym, buf.last_move[idx])
    from alphafive_tpu.env import vector  # local import to avoid cycle
    feats = vector.features(env, board, buf.to_play[idx], last)
    return (feats, pi, buf.z[idx].astype(jnp.float32),
            buf.z_valid[idx].astype(jnp.float32),
            buf.pi_valid[idx].astype(jnp.float32))
