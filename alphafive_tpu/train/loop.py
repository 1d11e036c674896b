"""Host training driver: the self-play → train → evaluate pipeline.

Mirrors the reference's `TrainPipeline.run` control flow (SURVEY.md §3.1)
with the device work batched into one jitted SPMD iteration
(parallel/mesh.py). The host only sequences iterations, logs metrics,
runs the periodic eval gate (pure-MCTS ladder → Elo, SURVEY.md §3.5), and
checkpoints full state (train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import jax

from alphafive_tpu.config import RunConfig
from alphafive_tpu import parallel
from alphafive_tpu.models.evaluator import net_evaluator, rollout_evaluator
from alphafive_tpu.train import checkpoint as ckpt
from alphafive_tpu.train.evaluate import evaluate_vs
from alphafive_tpu.utils.elo import LadderState, update_ladder
from alphafive_tpu.utils.logging import MetricsLogger


def train(cfg: RunConfig, workdir: Optional[str] = None,
          total_iters: Optional[int] = None, resume: bool = False,
          mesh=None, logger: Optional[MetricsLogger] = None,
          profile_iters: int = 0, init_from: Optional[str] = None):
    """Run the pipeline. Returns (carry, ladder) for inspection.

    profile_iters > 0 captures a `jax.profiler` device trace of iterations
    [2, 2+profile_iters) into <workdir>/profile (SURVEY.md §5.1), viewable
    in TensorBoard / Perfetto.

    init_from warm-starts a FRESH run's net from an exported model via
    function-preserving surgery (models/surgery.py); a resumed checkpoint
    takes precedence (the warm start already happened in that run).
    """
    total = total_iters if total_iters is not None else cfg.train.total_iters
    # multi-host: the global mesh spans all processes' devices; only the
    # primary process writes logs and checkpoints (SURVEY.md §5.8)
    from alphafive_tpu.parallel import distributed
    primary = distributed.is_primary()
    if mesh is None:
        n = cfg.mesh.data if jax.process_count() == 1 else len(jax.devices())
        mesh = parallel.make_mesh(n)
    log = logger or MetricsLogger(workdir if primary else None,
                                  quiet=not primary)
    # checkpoint save is collective: every process writes its own shards
    # (train/checkpoint.py), the primary publishes the step
    mgr = ckpt.make_manager(f"{workdir}/ckpt") if workdir else None

    key = jax.random.key(cfg.train.seed)
    key, kinit = jax.random.split(key)
    carry = parallel.init_carry(cfg, kinit, mesh)
    ladder = LadderState(max_rollouts=cfg.train.max_anchor_rollouts)
    start_iter = 0

    if resume and mgr is not None and mgr.latest_step() is not None:
        start_iter, carry, key, cfg_saved, ladder = ckpt.restore(mgr, carry)
        assert cfg_saved.env == cfg.env, "resume with a different env config"
        # evals run AFTER the checkpoint within an iteration, so their
        # ladder mutations (history entry, promotion) are persisted to a
        # cheap sidecar (below); prefer it when it is at least as new as
        # the checkpoint, or a crash between eval and the next checkpoint
        # would stall promotions and corrupt best-model tracking
        side = _read_ladder_sidecar(workdir)
        if side is not None and side[0] >= start_iter:
            ladder = side[1]
        # the CURRENT config's anchor cap wins over a saved ladder that
        # already promoted past it (e.g. after tightening the cap to
        # bound eval cost)
        ladder.max_rollouts = min(ladder.max_rollouts,
                                  cfg.train.max_anchor_rollouts)
        while ladder.level > 0 and ladder.anchor_rollouts > ladder.max_rollouts:
            ladder.level -= 1
        log.log({"kind": "resume", "iter": start_iter})
    elif init_from is not None:
        carry = _apply_transfer_init(cfg, carry, init_from, key, mesh)
        log.log({"kind": "transfer_init", "src": init_from})

    iteration = parallel.make_train_iteration(cfg, mesh)
    sims = cfg.mcts.num_simulations
    n_chips = mesh.devices.size

    for it in range(start_iter, total):
        if profile_iters and workdir and it == start_iter + 2:
            jax.profiler.start_trace(f"{workdir}/profile")
        if profile_iters and workdir and it == start_iter + 2 + profile_iters:
            jax.profiler.stop_trace()
            log.log({"kind": "profile", "dir": f"{workdir}/profile"})
        key, kit = jax.random.split(key)
        t0 = time.time()
        carry, metrics = iteration(carry, kit)
        metrics = jax.tree.map(float, jax.device_get(metrics))
        dt = time.time() - t0
        env_steps = metrics["env_steps"]
        log.log({
            "kind": "iter", "iter": it, **metrics,
            "iter_seconds": dt,
            "env_steps_per_s": env_steps / dt,
            "env_steps_per_s_per_chip": env_steps / dt / n_chips,
            "sims_per_s": env_steps * sims / dt,
            # canary: fraction of iters with the KL controller pinned at
            # its 0.1 floor (learner.adapt_lr_scale clip). A sustained
            # rolling mean near 1.0 means base-lr updates are ~10× the KL
            # target — the 19×19 run sat there for iters 200–360 while
            # its value loss tracked a shifting data distribution
            # (docs/TRAINING.md "The late-run value-loss rise").
            "lr_at_floor": 1.0 if metrics.get("lr_scale", 1.0) <= 0.101
            else 0.0,
            # the symmetric canary: controller pinned at its UPPER cap
            # (train.lr_scale_max). The round-5 lowsim_15x15 run spent
            # its last ~75 iterations at the 10× default cap, flattened
            # its policy (entropy_pi 2.0→4.9) and destroyed the net —
            # checkpoint 2500 beat the final 2615 export 111–17
            # (docs/TRAINING.md "The lr-ceiling runaway at 16-sim
            # budgets"). Alert on a sustained rolling mean near 1.0,
            # especially together with rising entropy_pi.
            "lr_at_ceiling": 1.0 if metrics.get("lr_scale", 1.0)
            >= cfg.train.lr_scale_max * 0.999 else 0.0,
        })

        # The eval key is split BEFORE the checkpoint so the saved key
        # already reflects it (resume stays bit-reproducible), and the
        # checkpoint lands BEFORE the eval gate: big-anchor evals are the
        # longest phase of an iteration, so if one dies the resume starts
        # AFTER this iteration, not checkpoint_every_iters back.
        do_eval = (cfg.train.eval_every_iters
                   and (it + 1) % cfg.train.eval_every_iters == 0)
        if do_eval:
            # dedicated split keeps the eval stream decorrelated from the
            # iteration keys (fold_in(key, it) on a key that is also split
            # for the next iteration risks correlated streams)
            key, keval = jax.random.split(key)
        if mgr is not None and (it + 1) % cfg.train.checkpoint_every_iters == 0:
            ckpt.save(mgr, it + 1, carry, key, cfg, ladder)
            log.log({"kind": "checkpoint", "iter": it + 1})
        if do_eval:
            elo = run_eval(cfg, carry, ladder, it, keval, log)
            if workdir and primary:
                _write_ladder_sidecar(workdir, it + 1, ladder)
            # Best-model gate (SURVEY.md §5.4/§3.5). Two regimes:
            #   * ladder live — promote on a new best performance Elo;
            #   * ladder MAXED and swept — the anchors carry no further
            #     signal (the round-4 19×19 run flew blind here), so
            #     promote on a net-vs-net match against the stored best
            #     (reference-family new-vs-best, train.best_gate_score).
            maxed = ladder.anchor_rollouts * 2 > ladder.max_rollouts
            swept = (ladder.history
                     and ladder.history[-1]["score"] >= ladder.promote_score)
            best_model_dir = f"{workdir}/best_model" if workdir else None
            have_best = (best_model_dir
                         and os.path.exists(
                             f"{best_model_dir}/{ckpt.MODEL_FILE}"))
            if maxed and swept and have_best:
                score = _eval_vs_best(cfg, carry, best_model_dir,
                                      jax.random.fold_in(keval, 0xBE57),
                                      it, log)
                promote = score >= cfg.train.best_gate_score
            else:
                best_so_far = max((h["elo"] for h in ladder.history[:-1]),
                                  default=-1e9)
                promote = elo is not None and elo > best_so_far
            if workdir and promote:
                ckpt.save(ckpt.make_manager(f"{workdir}/best",
                                            max_to_keep=1),
                          it + 1, carry, key, cfg, ladder)
                if primary:
                    ts = carry.train_state
                    ckpt.export_model(best_model_dir, ts.params,
                                      ts.batch_stats, cfg,
                                      extra={"iteration": it + 1})
                log.log({"kind": "best", "iter": it + 1, "elo": elo})

    if mgr is not None:
        ckpt.save(mgr, total, carry, key, cfg, ladder)
    return carry, ladder


def _apply_transfer_init(cfg: RunConfig, carry, init_from: str,
                         key: jax.Array, mesh):
    """Replace the fresh carry's net with a surgery-transferred one.

    The optimizer state is re-initialized for the transferred params (Adam
    moments from the random init would be meaningless), everything else in
    the carry (envs, replay, pending) is untouched.
    """
    from alphafive_tpu.models import surgery
    from alphafive_tpu.parallel.mesh import carry_shardings
    from alphafive_tpu.train import learner

    src_params, src_bs, src_cfg = ckpt.load_model(init_from)
    variables = surgery.transfer(
        {"params": src_params, "batch_stats": src_bs},
        src_cfg.env, src_cfg.net, cfg.env, cfg.net,
        jax.random.fold_in(key, 0x5117))
    opt = learner.make_optimizer(cfg.train)
    ts = carry.train_state.replace(
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=opt.init(variables["params"]))
    carry = carry.replace(train_state=ts)
    return jax.device_put(carry, carry_shardings(mesh, carry))


def _write_ladder_sidecar(workdir: str, iteration: int,
                          ladder: LadderState) -> None:
    tmp = f"{workdir}/ladder.json.tmp"
    with open(tmp, "w") as f:
        json.dump({"iter": iteration,
                   "ladder": dataclasses.asdict(ladder)}, f)
    os.replace(tmp, f"{workdir}/ladder.json")


def _read_ladder_sidecar(workdir: Optional[str]):
    path = f"{workdir}/ladder.json" if workdir else None
    if not path or not os.path.exists(path):
        return None
    from alphafive_tpu.train.checkpoint import _ladder_from_dict
    with open(path) as f:
        d = json.load(f)
    return int(d["iter"]), _ladder_from_dict(d["ladder"])


def _eval_vs_best(cfg: RunConfig, carry, best_model_dir: str,
                  key: jax.Array, it: int, log: MetricsLogger) -> float:
    """Current net vs the stored best model, SAME search config both
    sides (isolates net quality), randomized openings because both
    players are deterministic greedy. Returns the current net's score."""
    ts = carry.train_state
    cur = net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)
    bp, bbs, bcfg = ckpt.load_model(best_model_dir)
    best = net_evaluator(cfg.env, bcfg.net, bp, bbs)
    sims = cfg.train.eval_simulations or cfg.mcts.num_simulations
    res = evaluate_vs(cfg.env, cfg.mcts, cur, best, sims, sims,
                      cfg.train.eval_games, key,
                      mcts_a=cfg.mcts, mcts_b=cfg.mcts,
                      opening_plies=2, plies_per_call=2)
    log.log({"kind": "eval_best", "iter": it, **res,
             "best_iteration": bcfg and _best_iteration(best_model_dir)})
    return res["score"]


def _best_iteration(best_model_dir: str):
    import json as _json
    try:
        with open(f"{best_model_dir}/config.json") as f:
            return _json.load(f).get("iteration")
    except Exception:
        return None


def run_eval(cfg: RunConfig, carry, ladder: LadderState, it: int,
             key: jax.Array, log: MetricsLogger):
    """Current net-MCTS vs the pure-MCTS anchor (SURVEY.md §3.5).

    The anchor always searches with the CANONICAL exact config (sequential
    PUCT, no depth cap) so its strength — and therefore the Elo scale — is
    preset-independent; only the net side uses the preset's search config.
    """
    from alphafive_tpu.config import MCTSConfig
    ts = carry.train_state
    net_eval = net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)
    anchor = rollout_evaluator(cfg.env)
    eval_sims = cfg.train.eval_simulations or cfg.mcts.num_simulations
    result = evaluate_vs(
        cfg.env, cfg.mcts, net_eval, anchor,
        eval_sims, ladder.anchor_rollouts,
        cfg.train.eval_games, jax.random.fold_in(key, it),
        mcts_a=cfg.mcts, mcts_b=MCTSConfig(),
        # one ply per device call once anchor searches get big: bounds the
        # time of each call (train/evaluate.py)
        plies_per_call=1 if ladder.anchor_rollouts >= 3_200 else 2)
    elo = update_ladder(ladder, result, it)
    log.log({"kind": "eval", "iter": it, **result, "elo": elo,
             "anchor_rollouts": ladder.history[-1]["anchor_rollouts"],
             "level": ladder.history[-1]["level"]})
    return elo
