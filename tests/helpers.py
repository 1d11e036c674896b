"""Shared test helpers (not a test module); chip_smoke.py uses them too."""

import jax
import jax.numpy as jnp
import numpy as np

from alphafive_tpu.env import vector
from alphafive_tpu.env.scalar import ScalarGomoku


# ---------------------------------------------------------------------------
# A frozen evaluator computable bit-identically in NumPy and XLA:
# integer arithmetic on the board, then one exact float division.
# ---------------------------------------------------------------------------

def _int_value(board_i32, size):
    weights = (np.arange(size * size) % 5 - 2).astype(np.int64)
    s = int(np.sum(board_i32.astype(np.int64) * weights))
    return np.float32((s % 7) - 3) / np.float32(8)


def np_eval(size):
    def evaluate(board, to_play, last):
        del to_play, last
        return (np.zeros(size * size, np.float32),
                _int_value(board.astype(np.int32), size))
    return evaluate


def jax_eval(size):
    weights = jnp.asarray((np.arange(size * size) % 5 - 2).astype(np.int32))

    def evaluate(board, to_play, last, key):
        del to_play, last, key
        s = jnp.sum(board.astype(jnp.int32) * weights[None, :], axis=-1)
        v = ((s % 7) - 3).astype(jnp.float32) / jnp.float32(8)
        return jnp.zeros((board.shape[0], size * size), jnp.float32), v
    return evaluate


def random_midgame(size, n_in_row, plies, seed):
    for s in range(seed, seed + 50):  # retry seeds that end early
        g = ScalarGomoku(size, n_in_row)
        rng = np.random.default_rng(s)
        for _ in range(plies):
            la = g.legal_actions()
            g.step(int(la[rng.integers(len(la))]))
            if g.done:
                break
        if not g.done:
            return g
    raise AssertionError("no live midgame position found")


def to_env_state(games):
    size = games[0].size
    return vector.EnvState(
        board=jnp.asarray(np.stack([g.board.reshape(-1) for g in games])),
        to_play=jnp.asarray(np.array([g.to_play for g in games], np.int8)),
        last_move=jnp.asarray(np.array([g.last_move for g in games],
                                       np.int32)),
        move_count=jnp.asarray(np.array([g.move_count for g in games],
                                        np.int32)),
        done=jnp.zeros((len(games),), bool),
        winner=jnp.zeros((len(games),), jnp.int8),
    )


def frozen_net_evaluator(env_cfg, key):
    """Deterministic pseudo-random logits/values (position-dependent).
    Numpy weights (constants of whichever device runs the search) and
    float32 products at highest precision, so no device runs them in TF32.
    """
    a = env_cfg.num_actions
    w_l = np.asarray(jax.random.normal(key, (a, a), jnp.float32)) * 0.3
    w_v = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (a,),
                                       jnp.float32)) * 0.1
    hi = jax.lax.Precision.HIGHEST

    def evaluate(board, to_play, last, k):
        del last, k
        x = board.astype(jnp.float32) * to_play[:, None].astype(jnp.float32)
        return (jnp.dot(x, w_l, precision=hi),
                jnp.tanh(jnp.dot(x, w_v, precision=hi)))

    return evaluate
