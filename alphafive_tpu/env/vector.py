"""Vectorized, jit-friendly Gomoku/Renju engine.

Accelerator-first redesign of the reference's scalar board class
(SURVEY.md §1 L1): ``E`` boards step in lockstep as flat ``int8[E, A]``
tensors under ``jit`` / ``vmap`` (BASELINE.json north star: "vectorized
Gomoku engine stepping thousands of boards in lockstep under jit ...
vectorized five-in-a-row win detection via convolutional line scans").

Win detection is a *local* line scan: only the 4 lines through the stone just
placed can complete a run, so each step gathers a fixed 11-cell window per
direction (precomputed index/validity tables, built once per board size on
the host) and computes the consecutive-run length through the center with a
masked cumulative product — O(44) work per env per step instead of a
full-board convolution, same result. An 11-cell window measures runs exactly
up to length 6, which is sufficient to classify freestyle (>=5) and
renju_lite (==5 vs >=6) outcomes: any run containing the center that measures
exactly 5 has both endpoints within ±4, so a 6th stone would be visible.

Semantics are kept in exact lockstep with env/scalar.py (the parity oracle,
SURVEY.md §4); tests/test_env_vector.py enforces fixed-seed trajectory
equality per ply (BASELINE.json:5), tests/test_renju.py the renju variants.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from alphafive_tpu.config import EnvConfig, FREESTYLE, RENJU, RENJU_LITE
from alphafive_tpu.utils import pytree

WINDOW = 11  # offsets -5..5 through the placed stone
HALF = WINDOW // 2
_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


@pytree.dataclass
class EnvState:
    """Batched game state. All arrays lead with the env axis E."""

    board: jnp.ndarray      # int8[E, A]  (+1 black, -1 white, 0 empty)
    to_play: jnp.ndarray    # int8[E]     (+1 / -1)
    last_move: jnp.ndarray  # int32[E]    (flat action, -1 before first move)
    move_count: jnp.ndarray  # int32[E]
    done: jnp.ndarray       # bool[E]
    winner: jnp.ndarray     # int8[E]     (+1 / -1 / 0)


@functools.lru_cache(maxsize=None)
def line_onehot_table(size: int) -> np.ndarray:
    """int8[A, 4*W, A] one-hot rows: row (a, k) selects cell idx[a, k].

    Lets the line-window gather run as one scalar-row gather plus an int8
    matmul instead of a 44-element take_along_axis per board, which
    lowered to a slow generic-gather path on the accelerator this was
    first tuned for (round-1 finding, at the [E·leaf_batch, 44] expansion
    shape). ~2.2 MB at 15×15, built once."""
    idx, _ = line_tables(size)
    a = size * size
    flat = idx.reshape(a, -1)                      # [A, 4*W]
    table = np.zeros((a, flat.shape[1], a), dtype=np.int8)
    rows = np.arange(flat.shape[1])[None, :]
    table[np.arange(a)[:, None], rows, flat] = 1
    return table


@functools.lru_cache(maxsize=None)
def line_tables(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-action gather tables for the 4 lines through each cell.

    Returns (idx, ok): int32[A, 4, WINDOW] flat indices (clamped in-bounds)
    and bool[A, 4, WINDOW] validity masks. Host-side, cached per board size.
    """
    a = size * size
    idx = np.zeros((a, 4, WINDOW), dtype=np.int32)
    ok = np.zeros((a, 4, WINDOW), dtype=bool)
    for act in range(a):
        r, c = divmod(act, size)
        for d, (dr, dc) in enumerate(_DIRECTIONS):
            for w in range(WINDOW):
                o = w - HALF
                rr, cc = r + o * dr, c + o * dc
                valid = 0 <= rr < size and 0 <= cc < size
                ok[act, d, w] = valid
                idx[act, d, w] = (rr * size + cc) if valid else 0
    return idx, ok


def init(cfg: EnvConfig, num_envs: int) -> EnvState:
    a = cfg.num_actions
    return EnvState(
        board=jnp.zeros((num_envs, a), dtype=jnp.int8),
        to_play=jnp.ones((num_envs,), dtype=jnp.int8),
        last_move=jnp.full((num_envs,), -1, dtype=jnp.int32),
        move_count=jnp.zeros((num_envs,), dtype=jnp.int32),
        done=jnp.zeros((num_envs,), dtype=bool),
        winner=jnp.zeros((num_envs,), dtype=jnp.int8),
    )


def _line_cells(cfg: EnvConfig, board: jnp.ndarray, action: jnp.ndarray):
    """(cells int8[E,4,W], ok bool[E,4,W]) for the 4 lines through action.

    The cell pick runs as onehot-slab row gather + int8 matmul (see
    line_onehot_table) — exact integer arithmetic, bit-identical to a
    take_along_axis gather."""
    e = board.shape[0]
    ok = jnp.asarray(line_tables(cfg.board_size)[1])[action]   # [E, 4, W]
    slab = jnp.asarray(line_onehot_table(cfg.board_size))[action]
    cells = jnp.einsum("ekb,eb->ek", slab, board,
                       preferred_element_type=jnp.int32)
    return cells.reshape(e, 4, WINDOW).astype(jnp.int8), ok


def _runs_from_cells(cells: jnp.ndarray, ok: jnp.ndarray,
                     player: jnp.ndarray) -> jnp.ndarray:
    own = (cells == player[:, None, None].astype(jnp.int8)) & ok
    # consecutive own-stones on each side of the center: unrolled AND-chain
    # (a 5-step cumprod lowered to reduce-window ops at [E·lb, 4, W]
    # shapes where this was first tuned — plain elementwise ops fuse)
    total = jnp.zeros(own.shape[:-1], jnp.int32)
    acc = jnp.ones(own.shape[:-1], bool)
    for k in range(1, HALF + 1):         # offsets +1..+5
        acc = acc & own[..., HALF + k]
        total = total + acc
    acc = jnp.ones(own.shape[:-1], bool)
    for k in range(1, HALF + 1):         # offsets -1..-5
        acc = acc & own[..., HALF - k]
        total = total + acc
    return 1 + total


def runs_through(cfg: EnvConfig, board: jnp.ndarray, action: jnp.ndarray,
                 player: jnp.ndarray) -> jnp.ndarray:
    """int32[E, 4]: longest run of `player` through `action`, per direction.

    `board` must already contain the placed stone. Exact for runs <= 6 (and
    lower-bounded by 6 beyond), which is all the rules need.
    """
    cells, ok = _line_cells(cfg, board, action)
    return _runs_from_cells(cells, ok, player)


def _renju_doubles(cells: jnp.ndarray, ok: jnp.ndarray) -> jnp.ndarray:
    """bool[E]: the just-placed BLACK stone (window center) made a
    double-four or double-three — vectorized mirror of
    scalar._renju_line_counts (the oracle); definitions documented there.
    Static Python loops over the <=5 window offsets unroll under jit.
    """
    blk = (cells == 1) & ok
    emp = (cells == 0) & ok

    # fours: 5-windows s..s+4 (s in 1..5 keeps the center inside)
    cand4 = jnp.stack([
        ((blk[..., s:s + 5].sum(-1) == 4) & (emp[..., s:s + 5].sum(-1) == 1)
         & ~blk[..., s - 1] & ~blk[..., s + 5])   # completion is exact 5
        for s in range(1, 6)], axis=-1)           # bool[E, 4, 5]
    fours = cand4.sum(-1)
    for s in range(1, 5):  # straight four = same stones in s and s+1
        fours -= (cand4[..., s - 1] & cand4[..., s]
                  & blk[..., s + 1:s + 5].all(-1))

    # open threes: 4-windows t..t+3 (t in 2..5 keeps the center inside)
    cand3 = jnp.stack([
        ((blk[..., t:t + 4].sum(-1) == 3) & (emp[..., t:t + 4].sum(-1) == 1)
         & emp[..., t - 1] & emp[..., t + 4]      # straight-four ends open
         & ~blk[..., t - 2] & ~blk[..., t + 5])   # both fives exact
        for t in range(2, 6)], axis=-1)           # bool[E, 4, 4]
    threes = cand3.sum(-1)
    for t in range(2, 5):  # consecutive three = same stones in t and t+1
        threes -= (cand3[..., t - 2] & cand3[..., t - 1]
                   & blk[..., t + 1:t + 4].all(-1))

    return (fours.sum(-1) >= 2) | (threes.sum(-1) >= 2)


def _outcome(cfg: EnvConfig, runs: jnp.ndarray, player: jnp.ndarray,
             cells: jnp.ndarray, ok: jnp.ndarray):
    """(win, forbidden) bool[E] — mirrors the scalar oracle exactly."""
    n = cfg.n_in_row
    if cfg.rules == FREESTYLE:
        return (runs >= n).any(-1), jnp.zeros(runs.shape[:-1], dtype=bool)
    white = player.astype(jnp.int32) < 0
    any_ge = (runs >= n).any(-1)
    exact = (runs == n).any(-1)
    over = (runs > n).any(-1)
    win = jnp.where(white, any_ge, exact)
    if cfg.rules == RENJU_LITE:
        forbidden = (~white) & over & ~exact
        return win, forbidden
    assert cfg.rules == RENJU
    doubles = _renju_doubles(cells, ok)
    forbidden = (~white) & ~exact & (over | doubles)
    return win, forbidden


def step(cfg: EnvConfig, state: EnvState, action: jnp.ndarray) -> EnvState:
    """Place `action[E]` for each env's player-to-move.

    Already-done envs are frozen (no-op) — callers auto-reset instead.
    Illegal actions on live envs are a caller bug (masked upstream).
    """
    e = state.board.shape[0]
    player = state.to_play
    board = state.board.at[jnp.arange(e), action].set(player)
    cells, ok = _line_cells(cfg, board, action)
    runs = _runs_from_cells(cells, ok, player)
    win, forbidden = _outcome(cfg, runs, player, cells, ok)
    count = state.move_count + 1
    full = count >= cfg.num_actions
    done = win | forbidden | full
    winner = jnp.where(
        win, player, jnp.where(forbidden, -player, 0)
    ).astype(jnp.int8)

    frozen = state.done
    return EnvState(
        board=jnp.where(frozen[:, None], state.board, board),
        to_play=jnp.where(frozen, state.to_play, -player).astype(jnp.int8),
        last_move=jnp.where(frozen, state.last_move, action.astype(jnp.int32)),
        move_count=jnp.where(frozen, state.move_count, count),
        done=frozen | done,
        winner=jnp.where(frozen, state.winner, winner).astype(jnp.int8),
    )


def reset_where(cfg: EnvConfig, state: EnvState, mask: jnp.ndarray) -> EnvState:
    """Reset envs where mask[E] is True (lockstep auto-reset)."""
    m = mask
    return EnvState(
        board=jnp.where(m[:, None], jnp.int8(0), state.board),
        to_play=jnp.where(m, jnp.int8(1), state.to_play).astype(jnp.int8),
        last_move=jnp.where(m, jnp.int32(-1), state.last_move),
        move_count=jnp.where(m, 0, state.move_count),
        done=jnp.where(m, False, state.done),
        winner=jnp.where(m, jnp.int8(0), state.winner).astype(jnp.int8),
    )


def legal_mask(state: EnvState) -> jnp.ndarray:
    """bool[E, A]: empty cells of live games."""
    return (state.board == 0) & ~state.done[:, None]


def features(cfg: EnvConfig, board: jnp.ndarray, to_play: jnp.ndarray,
             last_move: jnp.ndarray) -> jnp.ndarray:
    """float32[E, S, S, 4] NHWC planes: own, opp, last-move, black-to-play.

    Same encoding as scalar.features (SURVEY.md §2 "Board engine"), in the
    net's NHWC conv layout. Takes raw fields (not EnvState) so the replay
    buffer can re-encode stored positions at sample time.
    """
    s = cfg.board_size
    e = board.shape[0]
    tp = to_play[:, None].astype(jnp.int8)
    own = (board == tp).astype(jnp.float32)
    opp = (board == -tp).astype(jnp.float32)
    last = jnp.zeros((e, cfg.num_actions), jnp.float32)
    valid = last_move >= 0
    last = last.at[jnp.arange(e), jnp.maximum(last_move, 0)].set(
        valid.astype(jnp.float32))
    black = jnp.broadcast_to(
        (to_play > 0).astype(jnp.float32)[:, None], (e, cfg.num_actions))
    planes = jnp.stack([own, opp, last, black], axis=-1)  # [E, A, 4]
    return planes.reshape(e, s, s, 4)


def state_features(cfg: EnvConfig, state: EnvState) -> jnp.ndarray:
    return features(cfg, state.board, state.to_play, state.last_move)
