"""Actor-learner pipeline: self-play chunk semantics, learner step, the
sharded train iteration on the fake 8-device mesh, checkpoint round-trip,
and the end-to-end smoke config (SURVEY.md §4 "Integration" /
"Distributed without a cluster").
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafive_tpu.config import get_preset
from alphafive_tpu.env import vector
from alphafive_tpu import parallel
from alphafive_tpu.models.evaluator import uniform_evaluator
from alphafive_tpu.train import actor, learner


@pytest.fixture(scope="module")
def tiny():
    return get_preset("tiny_test")


def test_selfplay_chunk_backfill(tiny):
    """Per-segment z correctness, asserted directly from the recordings:
    game boundaries are reconstructed from move_count resets; every ply of
    a finished segment must be z_valid with z·to_play equal to the single
    game winner, the winner must be the final mover (freestyle rules — the
    mover can never lose on their own move), and draws only on full boards.
    Trailing unfinished segments must be entirely invalid."""
    cfg = tiny
    e = 4
    t = 25  # 5x5 board fills in <= 25 plies -> every env finishes >= 1 game
    state = vector.init(cfg.env, e)
    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, cfg.env, cfg.mcts,
        uniform_evaluator(cfg.env), num_plies=t))
    state, traj, stats = fn(state, jax.random.key(0))

    assert traj.board.shape == (t * e, cfg.env.num_actions)
    assert int(stats.games_finished) >= e  # every env finished >= 1 game
    assert int(stats.env_steps) == t * e

    z = np.asarray(traj.z).reshape(t, e)
    valid = np.asarray(traj.z_valid).reshape(t, e)
    to_play = np.asarray(traj.to_play).reshape(t, e)
    pi = np.asarray(traj.pi).reshape(t, e, -1)
    board = np.asarray(traj.board).reshape(t, e, -1)
    move_count = (board != 0).sum(-1)  # stones on the RECORDED position

    # π is a distribution over empty cells of the recorded position
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    assert (pi[board != 0] == 0).all()

    full = cfg.env.num_actions
    checked_segments = 0
    for i in range(e):
        # segment starts: recorded position has 0 stones (fresh game)
        starts = [tt for tt in range(t) if move_count[tt, i] == 0]
        assert starts and starts[0] == 0
        bounds = starts + [t]
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            seg = slice(s0, s1)
            if s1 < t:
                # finished segment (a reset follows): all plies valid,
                # one consistent winner across the whole segment
                assert valid[seg, i].all(), (i, s0, s1)
                w = z[seg, i] * to_play[seg, i]
                assert (w == w[0]).all(), (i, s0, s1, w)
                t_end = s1 - 1
                # freestyle: the mover can't lose on their own move
                assert z[t_end, i] in (0, 1), (i, t_end)
                # draw only when the final move filled the board
                if z[t_end, i] == 0:
                    assert move_count[t_end, i] == full - 1, (i, t_end)
                checked_segments += 1
            else:
                # trailing segment: finished IFF the very last ply ended
                # the game; its validity must be uniform either way
                v = valid[seg, i]
                assert v.all() or (~v).all(), (i, s0, v)
    assert checked_segments >= e  # the loop actually exercised segments


def test_selfplay_z_consistency_within_game(tiny):
    """z·to_play (the game winner) is constant within each game segment."""
    cfg = tiny
    e, t = 2, 25
    state = vector.init(cfg.env, e)
    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, cfg.env, cfg.mcts,
        uniform_evaluator(cfg.env), num_plies=t))
    _, traj, _ = fn(state, jax.random.key(3))
    z = np.asarray(traj.z).reshape(t, e)
    valid = np.asarray(traj.z_valid).reshape(t, e)
    to_play = np.asarray(traj.to_play).reshape(t, e)
    count = np.asarray(traj.board).reshape(t, e, -1)
    move_count = (count != 0).sum(-1)

    for i in range(e):
        # game boundaries: move_count resets to 0
        w_seen = None
        for tt in range(t):
            if move_count[tt, i] == 0 and tt > 0:
                w_seen = None  # new game
            if valid[tt, i]:
                w = int(z[tt, i]) * int(to_play[tt, i])
                if w_seen is None:
                    w_seen = w
                assert w == w_seen, (i, tt)


def test_learner_step_decreases_loss(tiny):
    cfg = tiny
    key = jax.random.key(0)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, key)
    a = cfg.env.num_actions
    b = 64
    feats = jax.random.uniform(key, (b, cfg.env.board_size,
                                     cfg.env.board_size, 4))
    pi = jax.nn.softmax(jax.random.normal(key, (b, a)))
    z = jnp.sign(jax.random.normal(key, (b,)))
    batch = (feats, pi, z, jnp.ones((b,)))
    step = jax.jit(functools.partial(learner.train_step, cfg.net, cfg.train))
    losses = []
    for i in range(40):
        ts, aux = step(ts, batch)
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses[:3] + losses[-3:]
    assert int(ts.step) == 40


def test_resolve_chunk_lookahead_matches_concat(tiny):
    """One-chunk lookahead resolution (round 3) must equal resolving the
    concatenated double chunk and slicing the first half — the oracle for
    cross-chunk z backfill — and must strictly beat in-chunk resolution on
    coverage when games straddle the boundary."""
    cfg = tiny
    e, t = 4, 7  # 5x5/n4 games run ~8-20 plies -> most straddle 7-ply chunks
    state = vector.init(cfg.env, e)
    record = jax.jit(functools.partial(
        actor.selfplay_record, cfg.env, cfg.mcts,
        uniform_evaluator(cfg.env), num_plies=t))
    k1, k2 = jax.random.split(jax.random.key(3))
    state, recs1, _ = record(state, k1)
    state, recs2, _ = record(state, k2)

    look = actor.resolve_chunk(cfg.env, recs1, lookahead=recs2)
    both = jax.tree.map(lambda a, b: jnp.concatenate([a, b], 0),
                        recs1, recs2)
    oracle = actor.resolve_chunk(cfg.env, both)
    m = t * e
    np.testing.assert_array_equal(np.asarray(look.z_valid),
                                  np.asarray(oracle.z_valid)[:m])
    # z only meaningful where valid
    zv = np.asarray(look.z_valid)
    np.testing.assert_array_equal(np.asarray(look.z)[zv],
                                  np.asarray(oracle.z)[:m][zv])

    # coverage: strictly more than in-chunk resolution (straddling games)
    in_chunk = actor.resolve_chunk(cfg.env, recs1)
    assert zv.sum() > np.asarray(in_chunk.z_valid).sum()
    # and everything the in-chunk pass resolved is still resolved equally
    iv = np.asarray(in_chunk.z_valid)
    assert (zv | ~iv).all()
    np.testing.assert_array_equal(np.asarray(look.z)[iv],
                                  np.asarray(in_chunk.z)[iv])


def test_train_iteration_z_coverage(tiny):
    """The staged pipeline's written chunks reach ~full value-target
    coverage once lookahead kicks in (z_valid_frac metric), and the first
    iteration writes nothing (has_pending gate)."""
    cfg = dataclasses.replace(
        tiny, train=dataclasses.replace(tiny.train,
                                        selfplay_plies_per_iter=7))
    mesh = parallel.make_mesh(1)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    it = parallel.make_train_iteration(cfg, mesh, donate=False)
    sizes, fracs = [], []
    for i in range(4):
        carry, metrics = it(carry, jax.random.key(i))
        sizes.append(int(metrics["buffer_size"]))
        fracs.append(float(metrics["z_valid_frac"]))
    chunk = 7 * cfg.train.num_envs
    assert sizes[0] == 0 and sizes[1] == chunk and sizes[3] == 3 * chunk
    assert fracs[0] == 0.0  # nothing written yet
    # 5x5/n4 games last ~8-20 plies: in-chunk-only coverage of 7-ply
    # chunks would be far below this; lookahead lifts it near 1
    assert np.mean(fracs[1:]) > 0.75, fracs


def test_decoupled_decay_is_coefficient_bounded(tiny):
    """Round-3 head-collapse regression (train/learner.py docstring): under
    the old L2-in-loss + Adam, a vanishing data gradient let the normalized
    L2 gradient zero kernels at ~lr per step. With decoupled decay, a
    zero-data-gradient step must shrink a kernel by exactly lr·l2_coef·w
    (proportional, coefficient-bounded) and leave biases untouched."""
    cfg = tiny.train
    assert cfg.optimizer == "adam"
    params = {"dense": {"kernel": jnp.full((4, 4), 0.5),
                        "bias": jnp.full((4,), 0.5)}}
    opt = learner.make_optimizer(cfg)
    state = opt.init(params)
    zero_g = jax.tree.map(jnp.zeros_like, params)
    # a couple of steps so the schedule warms past 0
    for _ in range(3):
        updates, state = opt.update(zero_g, state, params)
    # the third update call sees schedule count 2 (counts start at 0)
    lr_now = min(2 / max(cfg.lr_warmup_steps, 1), 1.0) * cfg.learning_rate
    expect = -lr_now * cfg.l2_coef * 0.5
    np.testing.assert_allclose(np.asarray(updates["dense"]["kernel"]),
                               expect, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(updates["dense"]["bias"]), 0.0)
    # the decay pull is orders of magnitude below lr — the old pathology
    # (kernel zeroed at ~lr per step) would fail this by ~1/l2_coef
    assert abs(expect) < cfg.learning_rate * 1e-3


def test_adapt_lr_scale_respects_cap(tiny):
    """Tiny update-KL grows lr_scale only up to scale_max (the degenerate-
    policy amplification guard, config.TrainConfig.lr_scale_max)."""
    ts = learner.init_train_state(tiny.env, tiny.net, tiny.train,
                                  jax.random.key(0))
    for _ in range(10):
        ts = learner.adapt_lr_scale(ts, jnp.float32(1e-5), 0.02,
                                    scale_max=3.0)
    assert float(ts.lr_scale) == pytest.approx(3.0)
    # and a too-big KL walks it back down
    ts = learner.adapt_lr_scale(ts, jnp.float32(1.0), 0.02, scale_max=3.0)
    assert float(ts.lr_scale) == pytest.approx(2.0)


def test_train_iteration_8device_mesh(tiny):
    """The full SPMD program on the fake mesh: params stay replicated and
    identical, buffer fills, loss becomes finite once min_fill reached."""
    cfg = dataclasses.replace(
        tiny,
        train=dataclasses.replace(tiny.train, num_envs=8,
                                  selfplay_plies_per_iter=13,
                                  learner_steps_per_iter=2),
        replay=dataclasses.replace(tiny.replay, capacity=1024,
                                   batch_size=64, min_fill=64),
        mesh=dataclasses.replace(tiny.mesh, data=8),
    )
    mesh = parallel.make_mesh(8)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    it = parallel.make_train_iteration(cfg, mesh, donate=False)
    carry, m1 = it(carry, jax.random.key(1))
    carry, m2 = it(carry, jax.random.key(2))
    carry, m3 = it(carry, jax.random.key(3))
    # iter 0 stages only (one-chunk z lookahead); writes start at iter 1
    assert float(m1["buffer_size"]) == 0
    assert float(m3["buffer_size"]) > float(m2["buffer_size"]) > 0
    assert float(m2["updated"]) == 1.0
    assert np.isfinite(float(m2["loss"]))
    # params identical across devices (replicated invariant)
    p0 = jax.tree.leaves(carry.train_state.params)[0]
    shards = [np.asarray(s.data) for s in p0.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


def test_kl_early_stop_masks_steps(tiny):
    """kl_stop_factor > 0 aborts the update phase once the probe KL vs the
    phase-start policy exceeds factor·kl_target (SURVEY.md §3.1 reference
    guard-rail): with a huge lr and a tiny threshold only the tripping step
    executes; with the guard effectively off all steps run."""
    def run(kl_stop_factor):
        cfg = dataclasses.replace(
            tiny,
            train=dataclasses.replace(
                tiny.train, learner_steps_per_iter=4, learning_rate=1.0,
                lr_warmup_steps=1, kl_target=0.02,
                kl_stop_factor=kl_stop_factor),
            replay=dataclasses.replace(tiny.replay, min_fill=32,
                                       batch_size=32),
            mesh=dataclasses.replace(tiny.mesh, data=1),
        )
        mesh = parallel.make_mesh(1)
        carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
        it = parallel.make_train_iteration(cfg, mesh, donate=False)
        carry, m = it(carry, jax.random.key(1))  # stages only (lookahead)
        carry, m = it(carry, jax.random.key(2))
        assert float(m["updated"]) == 1.0
        return carry, m

    carry_stop, m_stop = run(kl_stop_factor=0.25)   # threshold 0.005
    carry_all, m_all = run(kl_stop_factor=1e9)      # never trips
    assert float(m_all["executed_steps"]) == 4.0
    assert float(m_stop["executed_steps"]) < 4.0
    assert float(m_stop["kl_update"]) > 0.005  # the guard really tripped
    # fewer optimizer steps were applied
    assert int(carry_stop.train_state.step) < int(carry_all.train_state.step)


def test_smoke_9x9_preset_end_to_end(tmp_path):
    """BASELINE.json:7 config 1 — the NAMED smoke_9x9 preset (9×9, 1 env,
    100-sim MCTS, 4-block 64-ch net, fixed seed) runs end-to-end on CPU:
    games finish, the learner engages once min_fill is reached, and loss
    is finite. (Kill-and-resume bit-reproducibility is covered by the
    stronger test_kill_and_resume_bit_reproducible above, which also
    compares the replay ring against an uninterrupted run — repeating
    the drill at this preset's 100-sim shapes added ~22 s of pure
    execution per suite run for no extra claim, round-2 verdict
    weak #8.)"""
    from alphafive_tpu.config import get_preset, ReplayConfig
    from alphafive_tpu.train.loop import train
    from alphafive_tpu.utils.logging import MetricsLogger

    cfg = get_preset("smoke_9x9")
    # The defining knobs of BASELINE cfg 1 stay untouched (9x9 board,
    # 1 env, 100-sim MCTS, 4-block 64-ch f32 net, fixed seed). Ancillary
    # cadence/replay thresholds shrink so the learner engages at iter 1
    # (the first iter only stages the z-lookahead chunk) and the test
    # stays the single largest suite cost (~25 s warm-cache on the
    # 1-core CI box; 24 plies/iter still finishes a game by iter 2 under
    # the fixed seed).
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, eval_every_iters=0,
                                  checkpoint_every_iters=1,
                                  selfplay_plies_per_iter=24),
        replay=ReplayConfig(capacity=20_000, batch_size=64, min_fill=24))

    wd_a = str(tmp_path / "a")
    logs = []
    rec = MetricsLogger(None, quiet=True)
    rec.log = lambda d, _orig=rec.log: (logs.append(d), _orig(d))[1]
    train(cfg, workdir=wd_a, total_iters=2, logger=rec)
    iters = [d for d in logs if d.get("kind") == "iter"]
    assert len(iters) == 2
    assert sum(d["games_finished"] for d in iters) >= 1
    assert iters[-1]["updated"] == 1.0
    assert np.isfinite(iters[-1]["loss"])


@pytest.mark.parametrize("preset", ["host_15x15", "multihost_15x15"])
def test_multidevice_presets_compile_and_step(preset):
    """The BASELINE cfg 3/4 presets' SPMD wiring (data=4 / data=8 mesh,
    sharded envs+ring, replicated params, pmean learner) compiles and runs
    one iteration on the fake CPU mesh at memory-reduced shape: board size
    and mesh layout are the presets' own; env counts / sims / net width are
    shrunk so the test is fast (VERDICT round-1 item 3)."""
    from alphafive_tpu.config import get_preset, NetConfig, ReplayConfig

    cfg = get_preset(preset)
    n = cfg.mesh.data
    assert n in (4, 8) and cfg.env.board_size == 15
    cfg = dataclasses.replace(
        cfg,
        net=NetConfig(blocks=1, channels=8, value_hidden=8,
                      compute_dtype="float32"),
        mcts=dataclasses.replace(cfg.mcts, num_simulations=8, max_depth=8),
        replay=ReplayConfig(capacity=64 * n, batch_size=8 * n,
                            min_fill=8 * n),
        train=dataclasses.replace(cfg.train, num_envs=2 * n,
                                  selfplay_plies_per_iter=4,
                                  learner_steps_per_iter=2),
    )
    mesh = parallel.make_mesh(n)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    it = parallel.make_train_iteration(cfg, mesh, donate=False)
    carry, m = it(carry, jax.random.key(1))
    carry, m = it(carry, jax.random.key(2))
    assert float(m["updated"]) == 1.0 and np.isfinite(float(m["loss"]))
    p0 = jax.tree.leaves(carry.train_state.params)[0]
    shards = [np.asarray(s.data) for s in p0.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


def test_lowsim_gumbel_preset_multidevice():
    """lowsim_15x15 (the aggregate-throughput config: gumbel root,
    16 sims) runs its full training iteration under the 8-device SPMD
    mesh at memory-reduced shape — the gumbel search path is otherwise
    only exercised single-device (dryrun_multichip uses the classic
    production search)."""
    from alphafive_tpu.config import NetConfig, ReplayConfig, get_preset

    n = 8
    cfg = get_preset("lowsim_15x15")
    assert cfg.mcts.root_selection == "gumbel"
    cfg = dataclasses.replace(
        cfg,
        mesh=dataclasses.replace(cfg.mesh, data=n),
        # branch_cap on top of the preset: covers the round-4
        # gumbel × capped-slot-tree combination under the SPMD mesh
        mcts=dataclasses.replace(cfg.mcts, branch_cap=32),
        net=NetConfig(blocks=1, channels=8, value_hidden=8,
                      compute_dtype="float32"),
        replay=ReplayConfig(capacity=64 * n, batch_size=8 * n,
                            min_fill=8 * n),
        train=dataclasses.replace(cfg.train, num_envs=2 * n,
                                  selfplay_plies_per_iter=4,
                                  learner_steps_per_iter=2),
    )
    mesh = parallel.make_mesh(n)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    it = parallel.make_train_iteration(cfg, mesh, donate=False)
    carry, m = it(carry, jax.random.key(1))
    carry, m = it(carry, jax.random.key(2))
    assert float(m["updated"]) == 1.0 and np.isfinite(float(m["loss"]))
    p0 = jax.tree.leaves(carry.train_state.params)[0]
    shards = [np.asarray(s.data) for s in p0.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


def test_ladder_sidecar_roundtrip(tmp_path):
    """Eval-time ladder mutations persist via the sidecar (evals run
    after the in-iteration checkpoint, so a crash in between must not
    lose promotions/history — round-2 review finding)."""
    from alphafive_tpu.train.loop import (_read_ladder_sidecar,
                                          _write_ladder_sidecar)
    from alphafive_tpu.utils.elo import LadderState

    assert _read_ladder_sidecar(str(tmp_path)) is None
    lad = LadderState(level=3, history=[{"step": 1, "elo": 42.0}])
    _write_ladder_sidecar(str(tmp_path), 50, lad)
    it, back = _read_ladder_sidecar(str(tmp_path))
    assert it == 50 and back == lad


def test_checkpoint_roundtrip(tiny, tmp_path):
    from alphafive_tpu.train import checkpoint as ckpt
    from alphafive_tpu.utils.elo import LadderState

    cfg = dataclasses.replace(
        tiny, mesh=dataclasses.replace(tiny.mesh, data=1))
    mesh = parallel.make_mesh(1)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    it = parallel.make_train_iteration(cfg, mesh, donate=False)
    carry, _ = it(carry, jax.random.key(1))

    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ladder = LadderState(level=2)
    ckpt.save(mgr, 7, carry, jax.random.key(9), cfg, ladder)

    carry0 = parallel.init_carry(cfg, jax.random.key(123), mesh)
    it2, carry2, key2, cfg2, ladder2 = ckpt.restore(mgr, carry0)
    assert it2 == 7 and ladder2.level == 2 and cfg2.env == cfg.env
    for a, b in zip(jax.tree.leaves(carry.train_state.params),
                    jax.tree.leaves(carry2.train_state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(carry.buffer.board),
                                  np.asarray(carry2.buffer.board))


def _save_sharded_checkpoint(tiny, tmp_path, n=4):
    """A tiny carry laid out over `n` devices, its replay boards filled
    with position-dependent values, saved as step 5."""
    from alphafive_tpu.train import checkpoint as ckpt
    from alphafive_tpu.utils.elo import LadderState

    cfg = dataclasses.replace(
        tiny, mesh=dataclasses.replace(tiny.mesh, data=n))
    carry = parallel.init_carry(cfg, jax.random.key(0), parallel.make_mesh(n))
    board = carry.buffer.board
    values = (np.arange(board.size) // 7 % 100).reshape(board.shape)
    carry = carry.replace(buffer=carry.buffer.replace(board=jax.device_put(
        values.astype(board.dtype), board.sharding)))
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ckpt.save(mgr, 5, carry, jax.random.key(2), cfg, LadderState())
    return mgr, carry


@pytest.mark.parametrize("layout", ["same", "one_device"])
def test_checkpoint_restores_sharded_carry(tiny, tmp_path, layout):
    """A carry saved from 4 devices restores leaf-for-leaf, onto the same
    sharding or onto one device (every block built from several pieces)."""
    from alphafive_tpu.train import checkpoint as ckpt

    mgr, carry = _save_sharded_checkpoint(tiny, tmp_path)
    like = carry if layout == "same" else jax.device_put(
        carry, jax.devices()[0])
    _, back, _, _, _ = ckpt.restore(mgr, like)
    for a, l, b in zip(jax.tree.leaves(carry), jax.tree.leaves(like),
                       jax.tree.leaves(back)):
        assert b.sharding == l.sharding
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_restore_fails_on_missing_shard_file(tiny, tmp_path):
    """Pieces split over two process files restore; with one file gone the
    restore raises instead of loading uninitialised memory."""
    import os

    from alphafive_tpu.train import checkpoint as ckpt

    mgr, carry = _save_sharded_checkpoint(tiny, tmp_path)
    step = mgr.step_dir(5)
    with np.load(os.path.join(step, "shards_0.npz")) as f:
        pieces = {k: f[k] for k in f.files}
    # pieces that do not start at the origin go to a second "process"
    second = {k: v for k, v in pieces.items()
              if any(not s.startswith("0:") for s in
                     k.partition("@")[2].split(",") if s)}
    assert second
    np.savez(os.path.join(step, "shards_0.npz"),
             **{k: v for k, v in pieces.items() if k not in second})
    np.savez(os.path.join(step, "shards_1.npz"), **second)
    _, back, _, _, _ = ckpt.restore(mgr, carry)
    np.testing.assert_array_equal(np.asarray(carry.buffer.board),
                                  np.asarray(back.buffer.board))

    os.remove(os.path.join(step, "shards_1.npz"))
    with pytest.raises(ValueError, match="a shard file is missing"):
        ckpt.restore(mgr, carry)


def test_graft_entry_single_and_multichip():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    logits, value = jax.jit(fn)(*args)
    assert logits.shape == (256, 225) and value.shape == (256,)
    ge.dryrun_multichip(8)


def test_kill_and_resume_bit_reproducible(tiny, tmp_path):
    """Fault-injection drill (SURVEY.md §5.3): training interrupted after
    k iterations and resumed from the checkpoint must produce the SAME
    parameters as an uninterrupted run — the checkpoint captures params,
    opt state, env states, the replay ring, the PRNG key, and counters."""
    from alphafive_tpu.train.loop import train
    from alphafive_tpu.utils.logging import MetricsLogger

    cfg = dataclasses.replace(
        tiny,
        mesh=dataclasses.replace(tiny.mesh, data=1),
        train=dataclasses.replace(tiny.train, eval_every_iters=0,
                                  checkpoint_every_iters=2,
                                  selfplay_plies_per_iter=6),
        replay=dataclasses.replace(tiny.replay, min_fill=8, batch_size=8),
    )
    quiet = MetricsLogger(None, quiet=True)

    # uninterrupted: 4 iterations
    wd_a = str(tmp_path / "a")
    carry_a, _ = train(cfg, workdir=wd_a, total_iters=4, logger=quiet)

    # interrupted: 2 iterations ("crash"), then resume to 4
    wd_b = str(tmp_path / "b")
    train(cfg, workdir=wd_b, total_iters=2, logger=quiet)
    carry_b, _ = train(cfg, workdir=wd_b, total_iters=4, resume=True,
                       logger=quiet)

    for a, b in zip(jax.tree.leaves(carry_a.train_state.params),
                    jax.tree.leaves(carry_b.train_state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(carry_a.buffer.board),
                                  np.asarray(carry_b.buffer.board))
    assert int(carry_a.buffer.size[0]) == int(carry_b.buffer.size[0])


def test_model_export_roundtrip(tiny, tmp_path):
    """export_model/load_model: the distributable params-only artifact."""
    from alphafive_tpu.train import checkpoint as ckpt

    cfg = dataclasses.replace(
        tiny, mesh=dataclasses.replace(tiny.mesh, data=1))
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train,
                                  jax.random.key(4))
    d = str(tmp_path / "model")
    ckpt.export_model(d, ts.params, ts.batch_stats, cfg,
                      extra={"iteration": 42})
    params, batch_stats, cfg2 = ckpt.load_model(d)
    assert cfg2.env == cfg.env and cfg2.net == cfg.net
    for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_train_state_from_any_preset(tiny, tmp_path):
    """restore_train_state rebuilds shapes from the SAVED config, so a
    checkpoint written by one preset loads under any caller preset."""
    from alphafive_tpu.train import checkpoint as ckpt
    from alphafive_tpu.utils.elo import LadderState

    cfg = dataclasses.replace(
        tiny, mesh=dataclasses.replace(tiny.mesh, data=1))
    mesh = parallel.make_mesh(1)
    carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ckpt.save(mgr, 3, carry, jax.random.key(1), cfg, LadderState())
    ts, saved_cfg = ckpt.restore_train_state(mgr)
    assert saved_cfg.train.num_envs == cfg.train.num_envs
    for a, b in zip(jax.tree.leaves(carry.train_state.params),
                    jax.tree.leaves(ts.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_playout_cap_randomization(tiny):
    """With small_simulations on, plies split into full (pi_valid) and
    cheap (value-only) searches; the split is per-ply, not per-env."""
    cfg = dataclasses.replace(
        tiny, mcts=dataclasses.replace(
            tiny.mcts, small_simulations=4, full_sim_fraction=0.5))
    e, t = 4, 20
    state = vector.init(cfg.env, e)
    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, cfg.env, cfg.mcts,
        uniform_evaluator(cfg.env), num_plies=t))
    _, traj, _ = fn(state, jax.random.key(5))
    pv = np.asarray(traj.pi_valid).reshape(t, e)
    # per-ply flag: all envs agree within a ply
    assert (pv.all(axis=1) | (~pv).all(axis=1)).all()
    assert pv.any() and (~pv).any()  # both kinds occurred (p=0.5, t=20)
    # π rows are proper distributions regardless of budget
    sums = np.asarray(traj.pi).sum(-1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)


def test_forced_playouts_and_pruning(tiny):
    """forced_playouts_k forces visited root children to a sqrt(k p N)
    floor during noisy search, and π extraction prunes the forced share."""
    import numpy as _np
    from alphafive_tpu.mcts import search as _search
    from alphafive_tpu.train.actor import prune_forced_visits

    # pruning math on a hand-made case
    visits = jnp.asarray([[20.0, 8.0, 2.0, 0.0]])
    priors = jnp.asarray([[0.4, 0.3, 0.2, 0.1]])
    # n_forced = sqrt(2*p*30): child1 8-4.24=3.76 (partial), child2 -> 0
    out = _np.asarray(prune_forced_visits(visits, priors, 2.0))
    assert out[0, 0] == 20.0                      # best child untouched
    assert 0.0 < out[0, 1] < 8.0                  # partially pruned
    assert out[0, 2] == 0.0 and out[0, 3] == 0.0
    # k=0 is the identity
    _np.testing.assert_array_equal(
        _np.asarray(prune_forced_visits(visits, priors, 0.0)),
        _np.asarray(visits))

    # end-to-end: forced search spreads root visits wider than plain PUCT
    cfg_f = dataclasses.replace(
        tiny.mcts, num_simulations=48, forced_playouts_k=2.0)
    e = 4
    state = vector.init(tiny.env, e)
    rf = jax.jit(functools.partial(
        _search.run_mcts, tiny.env, cfg_f, uniform_evaluator(tiny.env),
        add_noise=True))(state, jax.random.key(0))
    rp = jax.jit(functools.partial(
        _search.run_mcts, tiny.env, tiny.mcts, uniform_evaluator(tiny.env),
        add_noise=True, num_simulations=48))(state, jax.random.key(0))
    vf, vp = np.asarray(rf.visits), np.asarray(rp.visits)
    assert (vf != vp).any()  # the knob changes the search
    assert (vf.sum(-1) == vp.sum(-1)).all()  # same total budget
    # forced playouts push visited children toward the sqrt(k p N) floor:
    # the minimum visit count among visited children cannot shrink
    def min_visited(v):
        return np.where(v > 0, v, np.inf).min(-1)
    assert (min_visited(vf) >= min_visited(vp)).all()


def test_train_init_from_transfer(tiny, tmp_path):
    """`train(init_from=...)` warm-starts a fresh run via model surgery:
    the first checkpoint's trunk must carry the SOURCE model's weights
    (widened/deepened/board-resized), not a random init."""
    from alphafive_tpu.config import EnvConfig, NetConfig
    from alphafive_tpu.train import checkpoint as ckpt
    from alphafive_tpu.train.loop import train
    from alphafive_tpu.utils.logging import MetricsLogger

    # source: a smaller net on a smaller board, exported params-only
    src_cfg = dataclasses.replace(
        tiny, env=EnvConfig(board_size=4, n_in_row=4),
        net=NetConfig(blocks=1, channels=8, value_hidden=16,
                      compute_dtype="float32"),
        mesh=dataclasses.replace(tiny.mesh, data=1))
    src_ts = learner.init_train_state(src_cfg.env, src_cfg.net,
                                      src_cfg.train, jax.random.key(11))
    src_dir = str(tmp_path / "src_model")
    ckpt.export_model(src_dir, src_ts.params, src_ts.batch_stats, src_cfg)

    dst_cfg = dataclasses.replace(
        tiny, mesh=dataclasses.replace(tiny.mesh, data=1))
    carry, _ = train(dst_cfg, workdir=str(tmp_path / "run"), total_iters=1,
                     init_from=src_dir, mesh=parallel.make_mesh(1),
                     logger=MetricsLogger(None, quiet=True))
    # stem channels 8→16: the first 8 output filters are the source's
    # (up to one training iteration of drift — compare against random
    # instead: correlation with the source stem must be far above chance)
    got = np.asarray(carry.train_state.params["stem_conv"]["kernel"])
    src = np.asarray(src_ts.params["stem_conv"]["kernel"])
    # the run did 1 learner iteration; weights moved but must stay close
    # to the transferred init, not to an independent random draw
    delta = np.abs(got[..., :8] - src).mean()
    scale = np.abs(src).mean()
    assert delta < 0.5 * scale, (delta, scale)


def test_best_gate_switches_to_net_vs_net(tiny, tmp_path, monkeypatch):
    """Once the anchor ladder is MAXED and swept it carries no strength
    signal (the round-4 19×19 run flew blind past iter 249); the gate
    must then (a) export a params-only best_model on the first promotion
    and (b) judge later evals by a REAL net-vs-net match against it,
    logging an eval_best row (reference-family new-vs-best, SURVEY.md
    §3.5). The anchor eval is stubbed to a sweep; the net-vs-net match
    runs for real."""
    import json
    from alphafive_tpu.train import loop
    from alphafive_tpu.utils.elo import update_ladder

    def fake_run_eval(cfg, carry, ladder, it, key, log):
        result = {"score": 1.0, "games": 4, "wins": 4, "losses": 0,
                  "draws": 0}
        elo = update_ladder(ladder, result, it)
        log.log({"kind": "eval", "iter": it, **result, "elo": elo})
        return elo

    monkeypatch.setattr(loop, "run_eval", fake_run_eval)
    cfg = dataclasses.replace(
        tiny,
        train=dataclasses.replace(tiny.train, eval_every_iters=1,
                                  checkpoint_every_iters=1000,
                                  eval_simulations=8,
                                  max_anchor_rollouts=200))
    loop.train(cfg, workdir=str(tmp_path), total_iters=2)

    # eval 1: ladder maxed+swept but no best yet -> Elo path promotes and
    # exports the lightweight best model
    assert (tmp_path / "best_model" / "model.npz").exists()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    kinds = [r["kind"] for r in rows]
    assert "best" in kinds
    # eval 2: best exists -> the gate played current-vs-best for real
    eb = [r for r in rows if r["kind"] == "eval_best"]
    assert len(eb) == 1
    assert eb[0]["games"] == 4
    assert 0.0 <= eb[0]["score"] <= 1.0
    # iter rows carry both KL-controller clamp canaries (the floor caught
    # the 19×19 drift; the CEILING caught the round-5 lowsim runaway —
    # docs/TRAINING.md "The lr-ceiling runaway at 16-sim budgets")
    iters = [r for r in rows if r["kind"] == "iter"]
    assert all("lr_at_floor" in r for r in iters)
    assert all(r.get("lr_at_ceiling") in (0.0, 1.0) for r in iters)
