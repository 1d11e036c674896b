"""Lockstep self-play actor.

The reference plays one game at a time in a Python loop, recording
(state, π, player) and backfilling z from the winner at game end
(SURVEY.md §3.1 `start_self_play`). Redesign (SURVEY.md §7 hard
part 2): E envs play in lockstep under one `lax.scan` over plies with
masked auto-reset; the winner backfill is a reverse scan over the recorded
chunk, so the whole actor is shape-static and jit-compiled.

Targets: π is the raw visit distribution (τ=1); the *played* action is
sampled with τ=1 for the first `temperature_moves` plies of each game and
greedily afterwards — the reference family's temperature decay applied to
acting, with the canonical AlphaZero training target.

Positions whose game did not finish inside the resolution window get
`z_valid=False`: their π is still a valid policy target, but the value
target is masked in the learner (SURVEY.md §7 replay design). The
training pipeline widens that window with ONE-CHUNK LOOKAHEAD
(parallel/mesh.py round 3): raw per-ply recordings are staged for one
iteration and z-resolved against the NEXT chunk before entering the
replay ring, so any game ending within `num_plies` of a position's chunk
resolves. Measured motivation: 16-ply chunks against ~26-ply 19×19 Renju
games left only 33% of positions with a value target, biased toward game
endings (docs/TRAINING.md).

Playout cap randomization (KataGo, "Accelerating Self-Play Learning in
Go", PAPERS.md): when ``mcts_cfg.small_simulations > 0``, each ply flips a
coin — with probability ``full_sim_fraction`` the search runs the full
budget and the position's π is a training target (``pi_valid=True``);
otherwise a cheap ``small_simulations`` search just picks the move and the
position trains only the value head. Most positions become cheap while
policy targets keep full quality — a large self-play speedup at equal
strength.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.mcts import gumbel, search
from alphafive_tpu.utils import pytree


def prune_forced_visits(visits: jnp.ndarray, priors: jnp.ndarray,
                        forced_k: float) -> jnp.ndarray:
    """Policy target pruning (KataGo §3.4): subtract the forced share
    sqrt(k·p·Σn) from every non-best root child before normalizing π, so
    the exploration that forced playouts injected does not contaminate the
    policy target. Children pruned below 1 visit contribute nothing."""
    if forced_k <= 0:
        return visits
    n_sum = visits.sum(-1, keepdims=True)
    n_forced = jnp.sqrt(forced_k * priors * n_sum)
    best = jnp.argmax(visits, axis=-1)
    is_best = jax.nn.one_hot(best, visits.shape[-1], dtype=bool)
    pruned = jnp.maximum(visits - n_forced, 0.0)
    pruned = jnp.where(pruned < 1.0, 0.0, pruned)
    return jnp.where(is_best, visits, pruned)


@pytree.dataclass
class Trajectory:
    """Flattened chunk of T×E positions (leading axis T*E)."""

    board: jnp.ndarray     # int8[M, A]
    to_play: jnp.ndarray   # int8[M]
    last_move: jnp.ndarray  # int32[M]
    pi: jnp.ndarray        # f32[M, A]
    z: jnp.ndarray         # int8[M] (outcome from mover's perspective)
    z_valid: jnp.ndarray   # bool[M]
    pi_valid: jnp.ndarray  # bool[M] (full-budget search — π is a target)


@pytree.dataclass
class Recordings:
    """Raw per-ply recordings of a chunk, BEFORE z resolution ([T, E]).

    `board/to_play/last_move` describe the position the mover faced;
    `done/winner` describe the env AFTER the recorded move (the done flag
    that ends the game this ply belongs to). Staged in the train carry for
    one iteration so z can be resolved with next-chunk lookahead."""

    board: jnp.ndarray     # int8[T, E, A]
    to_play: jnp.ndarray   # int8[T, E]
    last_move: jnp.ndarray  # int32[T, E]
    pi: jnp.ndarray        # f32[T, E, A]
    done: jnp.ndarray      # bool[T, E]
    winner: jnp.ndarray    # int8[T, E]
    pi_valid: jnp.ndarray  # bool[T, E]


def init_recordings(env_cfg: EnvConfig, num_plies: int,
                    num_envs: int) -> Recordings:
    """Zeroed staging buffer (used before the first chunk exists)."""
    t, e, a = num_plies, num_envs, env_cfg.num_actions
    return Recordings(
        board=jnp.zeros((t, e, a), jnp.int8),
        to_play=jnp.ones((t, e), jnp.int8),
        last_move=jnp.full((t, e), -1, jnp.int32),
        pi=jnp.zeros((t, e, a), jnp.float32),
        done=jnp.zeros((t, e), bool),
        winner=jnp.zeros((t, e), jnp.int8),
        pi_valid=jnp.zeros((t, e), bool),
    )


class SelfplayStats(NamedTuple):
    games_finished: jnp.ndarray  # int32[]
    env_steps: jnp.ndarray       # int32[]
    black_wins: jnp.ndarray      # int32[]
    white_wins: jnp.ndarray      # int32[]
    draws: jnp.ndarray           # int32[]
    mean_root_value: jnp.ndarray  # f32[]


def selfplay_record(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Callable,
    state: EnvState,
    key: jax.Array,
    num_plies: int,
    num_simulations: int | None = None,
) -> Tuple[EnvState, Recordings, SelfplayStats]:
    """Play `num_plies` lockstep plies in every env (auto-resetting),
    returning the raw recordings (z not yet resolved — see resolve_chunk)."""

    small = int(mcts_cfg.small_simulations or 0)
    full_budget = int(num_simulations or mcts_cfg.num_simulations)
    use_pcr = 0 < small < full_budget
    use_gumbel = mcts_cfg.root_selection == "gumbel"

    def do_search(st, ks, sims, noise):
        if use_gumbel:
            # Gumbel root search (mcts/gumbel.py): exploration is the
            # Gumbel noise itself, so self-play always samples it (noise
            # distinguishes only the puct path's Dirichlet/forced
            # playouts; cheap PCR plies here keep g-sampling — the paper's
            # self-play acting at any budget).
            return gumbel.run_gumbel_mcts(env_cfg, mcts_cfg, evaluate, st,
                                          ks, add_noise=True,
                                          num_simulations=sims)
        return search.run_mcts(env_cfg, mcts_cfg, evaluate, st, ks,
                               add_noise=noise, num_simulations=sims)

    def ply(carry, _):
        st, key = carry
        key, ks, ka, kc = jax.random.split(key, 4)
        if use_pcr:
            # one coin per lockstep ply (all envs share the sim budget —
            # the batched search is a single static-shape program). Only
            # full searches carry Dirichlet noise / forced playouts: cheap
            # plies should play the best cheap move, not explore (KataGo).
            full = jax.random.bernoulli(kc, mcts_cfg.full_sim_fraction)
            res = jax.lax.cond(
                full,
                lambda s, k: do_search(s, k, num_simulations, True),
                lambda s, k: do_search(s, k, small, False),
                st, ks)
            pi_valid_ply = jnp.broadcast_to(full, (st.board.shape[0],))
        else:
            res = do_search(st, ks, num_simulations, True)
            pi_valid_ply = jnp.ones((st.board.shape[0],), bool)
        if use_gumbel:
            # π target = improved policy, action = halving winner (the
            # played move needs no temperature: Gumbel sampling IS the
            # exploration, and the winner is a policy improvement even at
            # tiny budgets — the north-star low-sim regime)
            pi_target = res.pi_target
            action = res.action
        else:
            target_visits = prune_forced_visits(
                res.visits, res.priors, float(mcts_cfg.forced_playouts_k))
            visit_sum = jnp.maximum(target_visits.sum(-1, keepdims=True),
                                    1.0)
            pi_target = target_visits / visit_sum
            greedy = st.move_count >= mcts_cfg.temperature_moves
            pi_act = search.pi_from_visits(
                res.visits, jnp.ones(st.board.shape[0]), greedy)
            action = search.sample_actions(ka, pi_act)
        nxt = vector.step(env_cfg, st, action)
        rec = (st.board, st.to_play, st.last_move, pi_target,
               nxt.done, nxt.winner, res.root_value, pi_valid_ply)
        st = vector.reset_where(env_cfg, nxt, nxt.done)
        return (st, key), rec

    (state, _), recs = jax.lax.scan(ply, (state, key), None,
                                    length=num_plies)
    (boards, to_plays, lasts, pis, dones, winners, root_vals,
     pi_valids) = recs

    e = boards.shape[1]
    recordings = Recordings(
        board=boards, to_play=to_plays, last_move=lasts, pi=pis,
        done=dones, winner=winners, pi_valid=pi_valids)
    stats = SelfplayStats(
        games_finished=dones.sum().astype(jnp.int32),
        env_steps=jnp.int32(num_plies * e),
        black_wins=(winners == 1).sum().astype(jnp.int32),
        white_wins=(winners == -1).sum().astype(jnp.int32),
        draws=((winners == 0) & dones).sum().astype(jnp.int32),
        mean_root_value=root_vals.mean(),
    )
    return state, recordings, stats


def resolve_chunk(env_cfg: EnvConfig, recs: Recordings,
                  lookahead: Recordings | None = None) -> Trajectory:
    """z-resolve recordings into a flat Trajectory ([T*E]).

    The winner backfill is a reverse scan carrying "winner of the game
    this ply belongs to" (known once a later `done` has been seen). With
    `lookahead` (the chronologically NEXT chunk's recordings), the scan
    runs over both chunks so games that end within the lookahead chunk
    also resolve; only the first chunk's plies are emitted."""
    t = recs.done.shape[0]
    if lookahead is None:
        dones, winners = recs.done, recs.winner
    else:
        dones = jnp.concatenate([recs.done, lookahead.done], axis=0)
        winners = jnp.concatenate([recs.winner, lookahead.winner], axis=0)

    def rev(carry, rec):
        w, have = carry
        done, winner = rec
        w = jnp.where(done, winner, w)
        have = done | have
        return (w, have), (w, have)

    e = recs.done.shape[1]
    init = (jnp.zeros((e,), jnp.int8), jnp.zeros((e,), bool))
    _, (ws, valids) = jax.lax.scan(rev, init, (dones, winners),
                                   reverse=True)
    zs = (ws[:t] * recs.to_play).astype(jnp.int8)

    a = env_cfg.num_actions
    return Trajectory(
        board=recs.board.reshape(-1, a),
        to_play=recs.to_play.reshape(-1),
        last_move=recs.last_move.reshape(-1),
        pi=recs.pi.reshape(-1, a),
        z=zs.reshape(-1),
        z_valid=valids[:t].reshape(-1),
        pi_valid=recs.pi_valid.reshape(-1),
    )


def selfplay_chunk(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Callable,
    state: EnvState,
    key: jax.Array,
    num_plies: int,
    num_simulations: int | None = None,
) -> Tuple[EnvState, Trajectory, SelfplayStats]:
    """Play `num_plies` lockstep plies and z-resolve within the chunk
    (no lookahead — the single-shot API used by benchmarks and tests;
    the training pipeline stages Recordings for one-chunk lookahead)."""
    state, recs, stats = selfplay_record(
        env_cfg, mcts_cfg, evaluate, state, key, num_plies,
        num_simulations)
    return state, resolve_chunk(env_cfg, recs), stats
