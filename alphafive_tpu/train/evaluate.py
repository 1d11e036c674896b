"""Evaluation: pit two searchers in lockstep games (SURVEY.md §3.5).

The reference's `policy_evaluate` plays n games of current-net MCTS vs a
pure-MCTS anchor, swapping who moves first, and gates promotion on win rate.
Here all games of one color assignment run batched — both players are
array-MCTS instances (the anchor just uses the net-free rollout evaluator),
searches are greedy (no noise, τ→0).

Execution is HOST-STEPPED in small ply chunks rather than one device-side
while_loop over whole games: big-anchor searches (thousands of rollout
simulations per move) make a whole-game program run for minutes, so each
device call advances every live game by only `plies_per_call` plies and
returns, which bounds the time of every call; the host loops until all
games finish.

Because eval games never auto-reset, every live env has the same ply
parity, so "whose turn" is a scalar `lax.cond` on the ply index.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env import vector
from alphafive_tpu.mcts import search


def _play_plies(env_cfg: EnvConfig, mcts_black: MCTSConfig,
                mcts_white: MCTSConfig,
                eval_black: Callable, eval_white: Callable,
                sims_black: int, sims_white: int, plies_per_call: int,
                state, key, ply0):
    """Advance all live games by plies_per_call plies (jitted by caller)."""

    def do_search(mcts_cfg, evaluate, sims, st, k):
        """Greedy match-play action (branches return int32[E] so a
        gumbel side and a puct side stay cond-compatible)."""
        if mcts_cfg.root_selection == "gumbel":
            from alphafive_tpu.mcts import gumbel
            res = gumbel.run_gumbel_mcts(env_cfg, mcts_cfg, evaluate, st, k,
                                         num_simulations=sims,
                                         add_noise=False)
            return res.action  # deterministic halving winner (g = 0)
        res = search.run_mcts(env_cfg, mcts_cfg, evaluate, st, k,
                              num_simulations=sims, add_noise=False)
        return jnp.argmax(res.visits, axis=-1).astype(jnp.int32)

    def body(i, carry):
        st, key = carry
        key, ks = jax.random.split(key)
        action = jax.lax.cond(
            (ply0 + i) % 2 == 0,
            lambda s, k: do_search(mcts_black, eval_black, sims_black, s, k),
            lambda s, k: do_search(mcts_white, eval_white, sims_white, s, k),
            st, ks)
        # greedy action; frozen envs step harmlessly (no-op)
        return vector.step(env_cfg, st, action), key

    state, _ = jax.lax.fori_loop(0, plies_per_call, body, (state, key))
    return state


def random_openings(env_cfg: EnvConfig, num_games: int, plies: int,
                    key: jax.Array):
    """Board states after `plies` uniform-random legal moves (diverse
    starting positions so deterministic greedy players produce distinct
    games; `plies` must be even so black is to move and far smaller than
    any winning line so no opening can be terminal)."""
    assert plies % 2 == 0 and plies < 2 * env_cfg.n_in_row - 1
    state = vector.init(env_cfg, num_games)

    @jax.jit
    def one(state, k):
        legal = state.board == 0
        logits = jnp.where(legal, 0.0, -jnp.inf)
        acts = jax.random.categorical(k, logits, axis=-1).astype(jnp.int32)
        return vector.step(env_cfg, state, acts)

    for k in jax.random.split(key, plies):
        state = one(state, k)
    return state


def play_games(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
               eval_black: Callable, eval_white: Callable,
               sims_black: int, sims_white: int,
               num_games: int, key: jax.Array,
               plies_per_call: int = 2,
               mcts_black: Optional[MCTSConfig] = None,
               mcts_white: Optional[MCTSConfig] = None,
               init_state=None):
    """Black = eval_black searcher, white = eval_white. Returns final state.

    Per-side search configs (A/B experiments) default to `mcts_cfg`;
    `init_state` (e.g. random_openings) replaces the empty boards — its
    move_count parity must put black to move."""
    state = vector.init(env_cfg, num_games) if init_state is None else init_state
    step_fn = jax.jit(functools.partial(
        _play_plies, env_cfg, mcts_black or mcts_cfg, mcts_white or mcts_cfg,
        eval_black, eval_white, sims_black, sims_white, plies_per_call))
    ply = 0
    while ply < env_cfg.num_actions and not bool(state.done.all()):
        key, k = jax.random.split(key)
        state = step_fn(state, k, jnp.int32(ply))
        ply += plies_per_call
    return state


def evaluate_vs(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                eval_a: Callable, eval_b: Callable,
                sims_a: int, sims_b: int, num_games: int,
                key: jax.Array,
                mcts_a: Optional[MCTSConfig] = None,
                mcts_b: Optional[MCTSConfig] = None,
                opening_plies: int = 0,
                plies_per_call: int = 2) -> Dict[str, float]:
    """A plays black in half the games, white in the other half.

    Returns win/draw/loss counts and score for A (host floats).
    `opening_plies` > 0 starts both halves from the SAME random openings —
    required when both players are deterministic (greedy net-vs-net A/Bs
    would otherwise repeat one game N times).
    """
    if num_games % 2 or num_games < 2:
        raise ValueError(
            f"num_games must be even and >= 2 (got {num_games}): each side "
            "plays both colors the same number of times")
    # Per-side configs are honored VERBATIM (A/B experiments on any search
    # knob, including value_dtype, must actually exercise it); int16 value
    # sums with budgets beyond their range fall back to exact float32
    # inside run_mcts itself (ADVICE.md round-1 high finding).
    mcts_a = mcts_a if mcts_a is not None else mcts_cfg
    mcts_b = mcts_b if mcts_b is not None else mcts_cfg
    half = num_games // 2
    k1, k2, ko = jax.random.split(key, 3)
    init = (random_openings(env_cfg, half, opening_plies, ko)
            if opening_plies else None)

    fa = play_games(env_cfg, mcts_cfg, eval_a, eval_b, sims_a, sims_b,
                    half, k1, plies_per_call,
                    mcts_black=mcts_a, mcts_white=mcts_b,
                    init_state=init)   # A is black
    fb = play_games(env_cfg, mcts_cfg, eval_b, eval_a, sims_b, sims_a,
                    half, k2, plies_per_call,
                    mcts_black=mcts_b, mcts_white=mcts_a,
                    init_state=init)   # A is white
    wa = np.asarray(fa.winner)
    wb = np.asarray(fb.winner)
    wins = int((wa == 1).sum() + (wb == -1).sum())
    losses = int((wa == -1).sum() + (wb == 1).sum())
    draws = int((wa == 0).sum() + (wb == 0).sum())
    n = wins + losses + draws
    return {
        "games": n,
        "wins": wins,
        "losses": losses,
        "draws": draws,
        "score": (wins + 0.5 * draws) / max(n, 1),
    }
