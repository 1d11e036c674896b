"""Leaf evaluators for the array MCTS.

The search is evaluator-agnostic: anything with signature
``(board int8[E,A], to_play int8[E], last int32[E], key) -> (logits, value)``
plugs in. Three implementations mirror the reference's three players
(SURVEY.md §2): the policy-value net (MCTSPlayer), uniform priors (tests),
and net-free random rollouts (the pure-MCTS Elo anchor, §3.5).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, NetConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.models.resnet import apply_eval


def net_evaluator(env_cfg: EnvConfig, net_cfg: NetConfig, params,
                  batch_stats) -> Callable:
    """Policy-value-net leaf evaluator (batched: one forward per sim for all
    envs — vs the reference's batch-1 session.run, SURVEY.md §3.1)."""

    def evaluate(board, to_play, last, key):
        del key
        feats = vector.features(env_cfg, board, to_play, last)
        return apply_eval(net_cfg, params, batch_stats, feats)

    return evaluate


def uniform_evaluator(env_cfg: EnvConfig) -> Callable:
    """Uniform legal priors, zero values (structural tests)."""

    def evaluate(board, to_play, last, key):
        del to_play, last, key
        e = board.shape[0]
        return (jnp.zeros((e, env_cfg.num_actions), jnp.float32),
                jnp.zeros((e,), jnp.float32))

    return evaluate


def rollout_evaluator(env_cfg: EnvConfig, num_rollouts: int = 1) -> Callable:
    """Net-free evaluator: uniform priors + value from random playouts.

    The pure-MCTS baseline of the reference family (SURVEY.md §2
    "Pure-MCTS baseline", `MCTS_Pure`), used as the fixed Elo anchor in
    evaluation (§3.5). A playout plays uniformly-random legal moves to the
    end; the value is the mean outcome from the leaf player's perspective.
    Fully vectorized: one lax.while_loop over plies for all E envs.
    """
    a = env_cfg.num_actions

    def one_rollout(board, to_play, last, count, done, winner, key):
        st = EnvState(board=board, to_play=to_play, last_move=last,
                      move_count=count, done=done, winner=winner)

        def cond(c):
            st, _ = c
            return ~st.done.all()

        def body(c):
            st, key = c
            key, k = jax.random.split(key)
            legal = st.board == 0
            logits = jnp.where(legal, 0.0, -jnp.inf)
            acts = jax.random.categorical(k, logits, axis=-1).astype(
                jnp.int32)
            return vector.step(env_cfg, st, acts), key

        final, _ = jax.lax.while_loop(cond, body, (st, key))
        # outcome from the perspective of the player to move at the leaf
        return (final.winner * to_play).astype(jnp.float32)

    def evaluate(board, to_play, last, key):
        e = board.shape[0]
        count = (board != 0).sum(-1).astype(jnp.int32)
        done = jnp.zeros((e,), bool)
        winner = jnp.zeros((e,), jnp.int8)
        # leaves handed to the evaluator are never terminal (the search
        # substitutes exact values for terminal leaves), but a full board
        # would make the rollout loop spin — guard by treating it as done.
        full = count >= a
        keys = jax.random.split(key, num_rollouts)
        vals = jax.vmap(lambda k: one_rollout(board, to_play, last, count,
                                              done | full, winner, k))(keys)
        value = jnp.where(full, 0.0, vals.mean(0))
        return jnp.zeros((e, a), jnp.float32), value

    return evaluate
