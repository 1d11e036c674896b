"""Gumbel sequential-halving root search (mcts/gumbel.py) vs the scalar
NumPy oracle (reference.run_gumbel_reference): bit-equal visit counts and
chosen actions on frozen evaluators, plus schedule, tactics, and
actor/evaluate integration (SURVEY.md §4 "Unit (MCTS)" extended to the
round-3 Gumbel addition).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env.scalar import ScalarGomoku
from alphafive_tpu.mcts import gumbel, reference
from tests.helpers import _int_value, random_midgame, to_env_state


# frozen evaluator with NON-ZERO logits (Gumbel scores live on g + logits)
# computable bit-identically in NumPy and XLA: integer tables + one exact
# float division, board-dependent value as in test_mcts.

def _logit_table(size):
    a = np.arange(size * size)
    return (((a * 7 + 3) % 11 - 5) / np.float32(4)).astype(np.float32)


def np_eval(size):
    lt = _logit_table(size)

    def evaluate(board, to_play, last):
        del to_play, last
        return lt.copy(), _int_value(board.astype(np.int32), size)
    return evaluate


def jax_eval(size):
    lt = jnp.asarray(_logit_table(size))
    weights = jnp.asarray((np.arange(size * size) % 5 - 2).astype(np.int32))

    def evaluate(board, to_play, last, key):
        del to_play, last, key
        s = jnp.sum(board.astype(jnp.int32) * weights[None, :], axis=-1)
        v = ((s % 7) - 3).astype(jnp.float32) / jnp.float32(8)
        return jnp.broadcast_to(lt, (board.shape[0], lt.shape[0])), v
    return evaluate


def _gumbel_table(size, num_envs):
    a = np.arange(size * size)[None, :]
    e = np.arange(num_envs)[:, None]
    return (((a * 13 + e * 29) % 17 - 8) / np.float32(8)).astype(np.float32)


def test_build_schedule_spends_budget_exactly():
    for budget, m in [(400, 16), (64, 16), (32, 16), (16, 16), (8, 16),
                      (5, 4), (7, 16), (1, 16), (240, 16), (3, 2)]:
        sched = gumbel.build_schedule(budget, m)
        assert sum(l * p for l, p in sched) == budget, (budget, m, sched)
        lanes = [l for l, _ in sched]
        assert lanes == sorted(lanes, reverse=True)  # halving never grows
        assert lanes[0] == min(m, budget)
    # the paper's canonical split: 64 sims over m=16 -> 16 each phase
    assert gumbel.build_schedule(64, 16) == [(16, 1), (8, 2), (4, 4), (2, 8)]


@pytest.mark.parametrize("size,n_in_row,sims,plies,m", [
    (5, 4, 30, 0, 8),    # empty board, full halving
    (5, 4, 17, 8, 8),    # odd budget: 1-lane remainder group
    (5, 4, 30, 18, 16),  # near-endgame: fewer legal moves than m -> padding
    (9, 5, 32, 10, 16),
])
def test_gumbel_visit_and_action_parity(size, n_in_row, sims, plies, m):
    env_cfg = EnvConfig(board_size=size, n_in_row=n_in_row)
    mcts_cfg = MCTSConfig(num_simulations=sims, c_puct=5.0, gumbel_m=m,
                          root_selection="gumbel")
    games = [random_midgame(size, n_in_row, plies, seed)
             for seed in (1, 2, 3, 4)]
    state = to_env_state(games)
    gtab = _gumbel_table(size, len(games))

    run = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(size)))
    res = run(state, jax.random.key(0), gumbel=jnp.asarray(gtab))
    visits = np.asarray(res.visits)
    actions = np.asarray(res.action)
    pis = np.asarray(res.pi_target)

    for i, g in enumerate(games):
        ref_n, ref_a, ref_pi = reference.run_gumbel_reference(
            g, np_eval(size), sims, c_puct=5.0, gumbel=gtab[i], m=m)
        np.testing.assert_array_equal(visits[i], ref_n, err_msg=f"env {i}")
        assert actions[i] == ref_a, f"env {i}: {actions[i]} != {ref_a}"
        np.testing.assert_allclose(pis[i], ref_pi, atol=1e-5,
                                   err_msg=f"env {i}")
        assert abs(pis[i].sum() - 1.0) < 1e-5


def test_gumbel_win_in_one():
    # black: 3 in a row open at both ends on 5x5 (n=4); 9 wins immediately
    env_cfg = EnvConfig(board_size=5, n_in_row=4)
    mcts_cfg = MCTSConfig(num_simulations=32, root_selection="gumbel")
    g = ScalarGomoku(5, 4)
    for mov in [6, 0, 7, 1, 8]:  # black 6,7,8 (row 1); white 0,1
        g.step(mov)
    g.step(2)  # white elsewhere; black to move, 5 or 9 completes 4-in-row
    state = to_env_state([g])
    res = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(5),
        add_noise=False))(state, jax.random.key(0))
    action = int(np.asarray(res.action)[0])
    assert action in (5, 9)  # either open end completes four in row 1
    # and the improved policy concentrates on the winning moves
    pi = np.asarray(res.pi_target)[0]
    assert pi[5] + pi[9] > 0.5


def test_gumbel_eval_deterministic():
    env_cfg = EnvConfig(board_size=5, n_in_row=4)
    mcts_cfg = MCTSConfig(num_simulations=16, root_selection="gumbel")
    g = random_midgame(5, 4, 6, 11)
    state = to_env_state([g])
    run = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(5),
        add_noise=False))
    a1 = int(np.asarray(run(state, jax.random.key(0)).action)[0])
    a2 = int(np.asarray(run(state, jax.random.key(7)).action)[0])
    assert a1 == a2  # g = 0: the key never enters the search


def test_gumbel_selfplay_records_improved_policy():
    from alphafive_tpu.train import actor

    env_cfg = EnvConfig(board_size=5, n_in_row=4)
    mcts_cfg = MCTSConfig(num_simulations=12, gumbel_m=8,
                          root_selection="gumbel", temperature_moves=4)
    state = __import__("alphafive_tpu.env.vector",
                       fromlist=["init"]).init(env_cfg, 4)
    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, env_cfg, mcts_cfg, jax_eval(5),
        num_plies=25))
    _, traj, stats = fn(state, jax.random.key(3))
    pi = np.asarray(traj.pi)
    board = np.asarray(traj.board)
    # π' rows are legal-masked distributions
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    assert (pi[board != 0] == 0).all()
    assert int(stats.games_finished) >= 1  # 25 plies finish 5x5 games
    # gumbel self-play with PCR: cheap plies are value-only targets
    mcts_pcr = MCTSConfig(num_simulations=12, gumbel_m=8,
                          root_selection="gumbel", small_simulations=4,
                          full_sim_fraction=0.5)
    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, env_cfg, mcts_pcr, jax_eval(5),
        num_plies=12))
    _, traj, _ = fn(state, jax.random.key(5))
    pv = np.asarray(traj.pi_valid).reshape(12, 4)
    assert pv.all(axis=1).any() and (~pv).all(axis=1).any()


def test_gumbel_match_play_vs_puct():
    """evaluate_vs accepts a gumbel side vs a puct side (the A/B harness
    path used for the low-budget strength studies)."""
    from alphafive_tpu.train.evaluate import evaluate_vs, random_openings

    env_cfg = EnvConfig(board_size=5, n_in_row=4)
    base = MCTSConfig(num_simulations=12)
    gcfg = MCTSConfig(num_simulations=12, root_selection="gumbel",
                      gumbel_m=8)
    ev = jax_eval(5)
    res = evaluate_vs(env_cfg, base, ev, ev, 12, 12, 4,
                      jax.random.key(2), mcts_a=gcfg, mcts_b=base,
                      opening_plies=2)
    assert res["games"] == 4
    assert 0.0 <= res["score"] <= 1.0


def test_gumbel_avoids_renju_forbidden_trap():
    """Renju × gumbel interaction: a double-three cell is LEGAL to play
    (board==0) but an instant loss for black. Even when the net's logits
    strongly prefer the trap, the gumbel root must visit it, see the
    terminal loss through σ(completed Q), and play something else with
    ~zero π' mass on the trap. (The production-cap interaction with
    forbidden traps at 19×19 is the round-2 verdict's task 5; this pins
    the gumbel root's half at unit level.)"""
    from alphafive_tpu.config import RENJU
    from tests.test_renju import make_position, rc, SIZE

    # black (7,5),(7,6) + (5,7),(6,7): playing (7,7) creates two open
    # threes -> forbidden (test_double_three_forbidden's position)
    g, st = make_position(
        blacks=[(7, 5), (7, 6), (5, 7), (6, 7)],
        whites=[(0, 0), (0, 1), (0, 2), (0, 3)])
    trap = rc(7, 7)

    def evaluate(board, to_play, last, key):
        del to_play, last, key
        logits = jnp.zeros((board.shape[0], SIZE * SIZE), jnp.float32)
        logits = logits.at[:, trap].set(4.0)  # net loves the trap
        return logits, jnp.zeros((board.shape[0],), jnp.float32)

    env_cfg = EnvConfig(board_size=SIZE, rules=RENJU)
    mcts_cfg = MCTSConfig(num_simulations=16, root_selection="gumbel")
    res = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, evaluate,
        add_noise=False))(st, jax.random.key(0))
    action = int(np.asarray(res.action)[0])
    assert action != trap
    # the trap WAS explored (it dominates g=0 scores pre-visit) ...
    assert float(res.visits[0, trap]) >= 1.0
    # ... and the improved policy pushes its mass to ~zero
    assert float(res.pi_target[0, trap]) < 0.01


@pytest.mark.parametrize("size,n_in_row,sims,plies,m", [
    (5, 4, 30, 0, 8),    # empty board, full halving
    (5, 4, 17, 8, 8),    # odd budget: 1-lane remainder group
    (5, 4, 30, 18, 16),  # near-endgame: fewer legal moves than m -> dup slots
    (9, 5, 32, 10, 16),
])
def test_gumbel_capped_full_width_matches_oracle(size, n_in_row, sims,
                                                 plies, m):
    """branch_cap == A: the slot-tree gumbel driver (forced-root hook,
    search_capped._run_pass) must match the scalar oracle bit-exactly on
    the same fixtures as the uncapped parity test."""
    env_cfg = EnvConfig(board_size=size, n_in_row=n_in_row)
    mcts_cfg = MCTSConfig(num_simulations=sims, c_puct=5.0, gumbel_m=m,
                          root_selection="gumbel",
                          branch_cap=size * size)
    games = [random_midgame(size, n_in_row, plies, seed)
             for seed in (1, 2, 3, 4)]
    state = to_env_state(games)
    gtab = _gumbel_table(size, len(games))

    run = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(size)))
    res = run(state, jax.random.key(0), gumbel=jnp.asarray(gtab))
    visits = np.asarray(res.visits)
    actions = np.asarray(res.action)
    pis = np.asarray(res.pi_target)

    for i, g in enumerate(games):
        ref_n, ref_a, ref_pi = reference.run_gumbel_reference(
            g, np_eval(size), sims, c_puct=5.0, gumbel=gtab[i], m=m)
        np.testing.assert_array_equal(visits[i], ref_n, err_msg=f"env {i}")
        assert actions[i] == ref_a, f"env {i}: {actions[i]} != {ref_a}"
        np.testing.assert_allclose(pis[i], ref_pi, atol=1e-5,
                                   err_msg=f"env {i}")


def test_gumbel_capped_packed_matches_uncapped_int16():
    """Production dtypes (packed s32 stats, bf16 priors, int16 values):
    capped gumbel at full width must equal the uncapped driver under the
    SAME quantization — both round values to 1/64 fixed point."""
    size, sims, m = 5, 24, 8
    env_cfg = EnvConfig(board_size=size, n_in_row=4)
    kw = dict(num_simulations=sims, c_puct=5.0, gumbel_m=m,
              root_selection="gumbel", prior_dtype="bfloat16",
              value_dtype="int16")
    cfg_un = MCTSConfig(**kw)
    cfg_cap = MCTSConfig(**kw, branch_cap=size * size)
    games = [random_midgame(size, 4, p, seed)
             for p, seed in [(0, 1), (6, 2), (10, 3)]]
    state = to_env_state(games)
    gtab = jnp.asarray(_gumbel_table(size, len(games)))
    ev = jax_eval(size)
    r_un = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, cfg_un, ev))(
            state, jax.random.key(0), gumbel=gtab)
    r_cap = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, cfg_cap, ev))(
            state, jax.random.key(0), gumbel=gtab)
    np.testing.assert_array_equal(np.asarray(r_un.visits),
                                  np.asarray(r_cap.visits))
    np.testing.assert_array_equal(np.asarray(r_un.action),
                                  np.asarray(r_cap.action))
    np.testing.assert_allclose(np.asarray(r_un.pi_target),
                               np.asarray(r_cap.pi_target), atol=1e-5)


def test_gumbel_capped_binding_cap_properties():
    """branch_cap < A (the cap actually binds below the root): the search
    must still spend the budget exactly, keep every root candidate
    reachable (root slots come from the gumbel top-m, never slot-dropped),
    and emit legal actions and normalized legal-masked targets."""
    size, sims, m = 9, 32, 16
    env_cfg = EnvConfig(board_size=size, n_in_row=5)
    mcts_cfg = MCTSConfig(num_simulations=sims, gumbel_m=m,
                          root_selection="gumbel", branch_cap=24,
                          prior_dtype="bfloat16", value_dtype="int16")
    games = [random_midgame(size, 5, p, seed)
             for p, seed in [(0, 1), (10, 2), (20, 3), (30, 4)]]
    state = to_env_state(games)
    res = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(size)))(
            state, jax.random.key(5))
    visits = np.asarray(res.visits)
    board = np.asarray(state.board)
    np.testing.assert_array_equal(visits.sum(-1), sims)
    # every visit and the played action land on legal moves
    assert (visits[board != 0] == 0).all()
    acts = np.asarray(res.action)
    assert (board[np.arange(len(games)), acts] == 0).all()
    pi = np.asarray(res.pi_target)
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    assert (pi[board != 0] == 0).all()
    # m > branch_cap clamps to the cap instead of overrunning slots
    small_cap = MCTSConfig(num_simulations=sims, gumbel_m=16,
                           root_selection="gumbel", branch_cap=8)
    res2 = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, small_cap, jax_eval(size)))(
            state, jax.random.key(6))
    np.testing.assert_array_equal(np.asarray(res2.visits).sum(-1), sims)


def test_gumbel_capped_win_in_one_and_renju_trap():
    """Tactics survive the marriage: win-in-one found, and the Renju
    double-three trap is explored then rejected — under the production
    slot-tree layout (branch_cap set)."""
    # win-in-one (same position as test_gumbel_win_in_one)
    env_cfg = EnvConfig(board_size=5, n_in_row=4)
    mcts_cfg = MCTSConfig(num_simulations=32, root_selection="gumbel",
                          branch_cap=16)
    g = ScalarGomoku(5, 4)
    for mov in [6, 0, 7, 1, 8, 2]:
        g.step(mov)
    state = to_env_state([g])
    res = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_cfg, mcts_cfg, jax_eval(5),
        add_noise=False))(state, jax.random.key(0))
    assert int(np.asarray(res.action)[0]) in (5, 9)
    pi = np.asarray(res.pi_target)[0]
    assert pi[5] + pi[9] > 0.5

    # Renju trap (same position as test_gumbel_avoids_renju_forbidden_trap)
    from alphafive_tpu.config import RENJU
    from tests.test_renju import make_position, rc, SIZE

    _, st = make_position(
        blacks=[(7, 5), (7, 6), (5, 7), (6, 7)],
        whites=[(0, 0), (0, 1), (0, 2), (0, 3)])
    trap = rc(7, 7)

    def evaluate(board, to_play, last, key):
        del to_play, last, key
        logits = jnp.zeros((board.shape[0], SIZE * SIZE), jnp.float32)
        logits = logits.at[:, trap].set(4.0)
        return logits, jnp.zeros((board.shape[0],), jnp.float32)

    env_r = EnvConfig(board_size=SIZE, rules=RENJU)
    cfg_r = MCTSConfig(num_simulations=16, root_selection="gumbel",
                       branch_cap=64)
    res = jax.jit(functools.partial(
        gumbel.run_gumbel_mcts, env_r, cfg_r, evaluate,
        add_noise=False))(st, jax.random.key(0))
    assert int(np.asarray(res.action)[0]) != trap
    assert float(res.visits[0, trap]) >= 1.0
    assert float(res.pi_target[0, trap]) < 0.01
