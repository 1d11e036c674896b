"""Command-line entry points: train / eval / play / bench.

The reference ships `python train.py` and a human-vs-AI `play.py`
(SURVEY.md §1 L6/L7, §3.4). Usage:

    python -m alphafive_tpu.cli train --preset chip_15x15 --workdir runs/x
    python -m alphafive_tpu.cli eval  --preset chip_15x15 --workdir runs/x
    python -m alphafive_tpu.cli play  --preset smoke_9x9 --workdir runs/x
    python -m alphafive_tpu.cli bench --preset chip_15x15

`--platform cpu` forces the local CPU backend (tests/debugging); the default
is whatever JAX selects (the GPU where one is present). `--set a.b=c`
overrides any config field.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional


def _is_optional_field(sub, field: str) -> bool:
    import typing
    hint = typing.get_type_hints(type(sub)).get(field)
    return hint is not None and type(None) in typing.get_args(hint)


def _parse_override_value(raw: str, old, optional: bool = False):
    if raw.lower() in ("none", "null"):
        # only Optional fields may be cleared: --set mcts.num_simulations=none
        # would otherwise plant a None that detonates deep in search setup
        # (round-3 advisor finding — the mirror image of the non-numeric
        # ValueError below)
        if optional or old is None:
            return None
        raise ValueError(
            f"override value {raw!r} only applies to Optional fields; "
            f"this field has type {type(old).__name__}")
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes")
    if old is None:  # Optional field (e.g. mcts.branch_cap/max_depth)
        for typ in (int, float):
            try:
                return typ(raw)
            except ValueError:
                pass
        # every current Optional field is numeric — a string here is a
        # typo that would otherwise surface as an obscure error deep in
        # search setup (round-2 advisor finding)
        raise ValueError(
            f"override value {raw!r} is not numeric (Optional fields "
            f"take int/float or none)")
    return type(old)(raw)


def _apply_overrides(cfg, overrides: List[str]):
    for ov in overrides:
        path, _, raw = ov.partition("=")
        assert raw, f"bad override {ov!r} (want section.field=value)"
        section, _, field = path.partition(".")
        sub = getattr(cfg, section)
        val = _parse_override_value(raw, getattr(sub, field),
                                    optional=_is_optional_field(sub, field))
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg


def _setup_platform(platform: Optional[str], num_cpu: int = 8):
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
        if platform == "cpu":
            jax.config.update("jax_num_cpu_devices", num_cpu)


def main(argv=None):
    p = argparse.ArgumentParser(prog="alphafive_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", default="chip_15x15")
        sp.add_argument("--workdir", default=None)
        sp.add_argument("--platform", default=None,
                        help="cpu|cuda (default: jax default)")
        sp.add_argument("--num-cpu-devices", type=int, default=8)
        sp.add_argument("--set", action="append", default=[],
                        metavar="SEC.FIELD=VAL", dest="overrides")
        sp.add_argument("--debug-nans", action="store_true",
                        help="jax_debug_nans: fault on NaN/Inf "
                             "(SURVEY.md §5.2 numeric sanitizer)")

    sp = sub.add_parser("train", help="run the actor-learner pipeline")
    common(sp)
    sp.add_argument("--allow-oversubscribe", action="store_true",
                    help="skip the per-device memory footprint guard "
                         "(utils/memory.py)")
    sp.add_argument("--iters", type=int, default=None)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--profile-iters", type=int, default=0,
                    help="capture a jax.profiler trace of N iterations")
    sp.add_argument("--init-from", default=None, metavar="MODEL_DIR",
                    help="warm-start a FRESH run from an exported model "
                         "via function-preserving surgery (widen/deepen/"
                         "board-resize, models/surgery.py); ignored when "
                         "--resume finds a checkpoint")
    # multi-process (BASELINE.json:10): run the same command once per
    # process (one per GPU host) with the same --coordinator and
    # --num-processes and a distinct --process-id
    sp.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed before building the mesh")
    sp.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (process 0's host)")
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)

    sp = sub.add_parser("eval", help="evaluate a checkpoint vs pure MCTS")
    common(sp)
    sp.add_argument("--games", type=int, default=None)
    sp.add_argument("--anchor-rollouts", type=int, default=1000)

    sp = sub.add_parser("play", help="human vs AI on the console")
    common(sp)
    sp.add_argument("--sims", type=int, default=None)
    sp.add_argument("--human-color", choices=["black", "white"],
                    default="black")
    sp.add_argument("--opponent", choices=["net", "pure"], default="net",
                    help="'pure' = net-free rollout MCTS (no checkpoint)")

    sp = sub.add_parser("bench", help="self-play throughput benchmark")
    common(sp)
    sp.add_argument("--allow-oversubscribe", action="store_true",
                    help="skip the per-device memory footprint guard "
                         "(utils/memory.py)")
    sp.add_argument("--plies", type=int, default=8)
    sp.add_argument("--mode", choices=["selfplay", "iteration"],
                    default="selfplay",
                    help="'iteration' benches the full actor-learner step "
                         "(self-play + replay + learner)")

    sp = sub.add_parser("export", help="export a workdir checkpoint as a "
                                       "distributable params-only model")
    common(sp)
    sp.add_argument("--out", required=True,
                    help="output dir (e.g. pretrained/9x9)")

    args = p.parse_args(argv)
    _setup_platform(args.platform, args.num_cpu_devices)
    if getattr(args, "debug_nans", False):
        import jax
        jax.config.update("jax_debug_nans", True)

    from alphafive_tpu.config import get_preset
    cfg = _apply_overrides(get_preset(args.preset), args.overrides)

    if getattr(args, "multihost", False):
        # before anything touches jax.devices(): the budget guard below
        # must see the global device list
        from alphafive_tpu.parallel import distributed
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id)
    if args.cmd in ("train", "bench"):
        _check_device_budget(cfg, args)

    if args.cmd == "train":
        from alphafive_tpu.train.loop import train
        train(cfg, workdir=args.workdir, total_iters=args.iters,
              resume=args.resume, profile_iters=args.profile_iters,
              init_from=args.init_from)
    elif args.cmd == "eval":
        _cmd_eval(cfg, args)
    elif args.cmd == "play":
        _cmd_play(cfg, args)
    elif args.cmd == "bench":
        _cmd_bench(cfg, args)
    elif args.cmd == "export":
        _cmd_export(cfg, args)
    return 0


def _check_device_budget(cfg, args):
    """Refuse device runs whose estimated per-device footprint exceeds the
    device's memory (utils/memory.py). A multi-device preset collapsed
    onto fewer devices is the usual culprit; the single-device row for
    such a preset is its per-device SHARD, e.g.:

        cli bench --preset multihost_15x15 --set mesh.data=1 \\
            --set train.num_envs=1024 --set replay.batch_size=512

    `--allow-oversubscribe` bypasses the guard.
    """
    if getattr(args, "allow_oversubscribe", False):
        return
    import jax
    if jax.devices()[0].platform == "cpu":
        return  # host RAM, not device memory — tests and debugging runs
    from alphafive_tpu.utils.memory import budget_error, device_budget
    err = budget_error(cfg, len(jax.devices()),
                       device_budget(jax.local_devices()[0]))
    if err is not None:
        raise SystemExit(err)


def _cmd_export(cfg, args):
    from alphafive_tpu.train import checkpoint as ckpt

    assert args.workdir, "--workdir with a checkpoint is required"
    mgr = ckpt.make_manager(f"{args.workdir}/ckpt")
    step = mgr.latest_step()
    assert step is not None, f"no checkpoint under {args.workdir}/ckpt"
    ts, saved_cfg = ckpt.restore_train_state(mgr)
    ckpt.export_model(args.out, ts.params, ts.batch_stats, saved_cfg,
                      extra={"iteration": step,
                             "lr_scale": float(ts.lr_scale),
                             "train_step": int(ts.step)})
    print(f"exported step {step} -> {args.out}")


def _pretrained_dir(cfg):
    """Bundled pretrained checkpoint for this board size, if shipped.

    The reference repo ships a ready-to-play model (SURVEY.md §2
    "Pretrained model"); ours live under <repo>/pretrained/<size>x<size>.
    Where a strength-ranked variant exists for the board (round-5
    net-vs-net matches), it is preferred — the loader uses the BUNDLE's
    saved net config, so a variant with a different architecture (the
    19×19 10-block) loads without any --set overrides:

    * 15×15 → `15x15_lowsim` (beats `15x15` at every neutral budget
      tried: +163/+246/+112 Elo at 240/64/16 sims — its README);
    * 19×19 → `19x19_10b` (beats `19x19` 61–3 at equal 240-sim
      search — its README).
    """
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = cfg.env.board_size
    # strongest-first per board (head-to-head ranked), plain dir last
    ranked = {15: ["15x15_lowsim"], 19: ["19x19_10b"]}
    for name in ranked.get(s, []) + [f"{s}x{s}"]:
        path = os.path.join(here, "pretrained", name)
        if os.path.isdir(path):
            return path
    return None


def _load_model(cfg, workdir):
    """(params, batch_stats, net_cfg) for inference.

    Priority: workdir's training checkpoint (restored against ITS saved
    config, so any preset can load it) → bundled pretrained model for this
    board size → fresh untrained net. The returned net_cfg is the one the
    weights were trained with — the caller must build the evaluator from
    it, not from the CLI preset.
    """
    import os
    import jax
    from alphafive_tpu.train import checkpoint as ckpt

    if workdir:
        # an explicit workdir must never silently fall through to the
        # bundled model — its results would be attributed to the run
        if os.path.isdir(f"{workdir}/ckpt"):
            mgr = ckpt.make_manager(f"{workdir}/ckpt")
            if mgr.latest_step() is not None:
                ts, saved_cfg = ckpt.restore_train_state(mgr)
                assert saved_cfg.env.board_size == cfg.env.board_size, (
                    "checkpoint board size differs from preset")
                print(f"restored checkpoint step {mgr.latest_step()} "
                      f"from {workdir}/ckpt", file=sys.stderr)
                return ts.params, ts.batch_stats, saved_cfg.net
        if os.path.exists(f"{workdir}/{ckpt.MODEL_FILE}"):
            # a params-only export dir (train/checkpoint.py export_model)
            # works anywhere a run dir does — eval/play straight off a
            # bundled or surgery-produced artifact
            params, batch_stats, saved_cfg = ckpt.load_model(workdir)
            assert saved_cfg.env.board_size == cfg.env.board_size, (
                "exported model board size differs from preset")
            print(f"loaded exported model from {workdir}", file=sys.stderr)
            return params, batch_stats, saved_cfg.net
        print(f"WARNING: no checkpoint under {workdir}/ckpt — using a "
              f"fresh (untrained) net", file=sys.stderr)
        from alphafive_tpu.models.resnet import init_variables
        variables = init_variables(cfg.env, cfg.net,
                                   jax.random.key(cfg.train.seed))
        return (variables["params"], variables.get("batch_stats", {}),
                cfg.net)

    pre = _pretrained_dir(cfg)
    if pre is not None:
        params, batch_stats, saved_cfg = ckpt.load_model(pre)
        print(f"loaded bundled pretrained model from {pre}",
              file=sys.stderr)
        return params, batch_stats, saved_cfg.net

    print("no checkpoint found; using a fresh (untrained) net",
          file=sys.stderr)
    from alphafive_tpu.models.resnet import init_variables
    variables = init_variables(cfg.env, cfg.net,
                               jax.random.key(cfg.train.seed))
    return (variables["params"], variables.get("batch_stats", {}),
            cfg.net)


def _cmd_eval(cfg, args):
    import jax
    from alphafive_tpu.models.evaluator import net_evaluator, rollout_evaluator
    from alphafive_tpu.train.evaluate import evaluate_vs
    from alphafive_tpu.utils.elo import performance_elo
    import json as _json

    from alphafive_tpu.config import MCTSConfig
    params, batch_stats, net_cfg = _load_model(cfg, args.workdir)
    result = evaluate_vs(
        cfg.env, cfg.mcts,
        net_evaluator(cfg.env, net_cfg, params, batch_stats),
        rollout_evaluator(cfg.env),
        cfg.train.eval_simulations or cfg.mcts.num_simulations,
        args.anchor_rollouts,
        args.games or cfg.train.eval_games,
        jax.random.key(cfg.train.seed + 1),
        # canonical exact anchor (preset-independent Elo scale); big
        # anchors advance one ply per device call (bounded call time)
        mcts_a=cfg.mcts, mcts_b=MCTSConfig(),
        plies_per_call=1 if args.anchor_rollouts >= 3_200 else 2)
    result["anchor_rollouts"] = args.anchor_rollouts
    result["elo_vs_anchor"] = performance_elo(result["score"], 0.0,
                                              games=result.get("games"))
    print(_json.dumps(result))


def _cmd_play(cfg, args):
    """Console human-vs-AI (SURVEY.md §3.4)."""
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np
    from alphafive_tpu.env import vector
    from alphafive_tpu.env.scalar import ScalarGomoku
    from alphafive_tpu.mcts import run_mcts
    from alphafive_tpu.models.evaluator import net_evaluator

    if args.opponent == "pure":
        from alphafive_tpu.models.evaluator import rollout_evaluator
        evaluate = rollout_evaluator(cfg.env)
    else:
        params, batch_stats, net_cfg = _load_model(cfg, args.workdir)
        evaluate = net_evaluator(cfg.env, net_cfg, params, batch_stats)
    sims = args.sims or cfg.mcts.num_simulations
    if cfg.mcts.root_selection == "gumbel":
        from alphafive_tpu.mcts import run_gumbel_mcts

        def _run(st, k):  # action = deterministic halving winner (g = 0)
            res = run_gumbel_mcts(cfg.env, cfg.mcts, evaluate, st, k,
                                  num_simulations=sims, add_noise=False)
            return res.action, res.root_value
    else:
        def _run(st, k):  # action = greedy argmax of visit counts
            res = run_mcts(cfg.env, cfg.mcts, evaluate, st, k,
                           num_simulations=sims, add_noise=False)
            return (jnp.argmax(res.visits, axis=-1).astype(jnp.int32),
                    res.root_value)
    run = jax.jit(_run)

    g = ScalarGomoku(cfg.env.board_size, cfg.env.n_in_row, cfg.env.rules)
    human = 1 if args.human_color == "black" else -1
    key = jax.random.key(0)
    print(f"You are {'X (black)' if human == 1 else 'O (white)'}; "
          f"enter moves as 'row col'. AI: {sims} simulations.")
    while not g.done:
        print(g.render())
        if g.to_play == human:
            try:
                line = input("your move> ").strip()
            except EOFError:
                print("bye"); return
            try:
                r, c = map(int, line.replace(",", " ").split())
                a = r * g.size + c
                assert a in g.legal_actions()
            except Exception:
                print("invalid move, try again (e.g. '7 7')")
                continue
        else:
            st = vector.EnvState(
                board=jnp.asarray(g.board.reshape(1, -1)),
                to_play=jnp.array([g.to_play], jnp.int8),
                last_move=jnp.array([g.last_move], jnp.int32),
                move_count=jnp.array([g.move_count], jnp.int32),
                done=jnp.array([False]), winner=jnp.array([0], jnp.int8))
            key, ks = jax.random.split(key)
            act, root_value = run(st, ks)
            a = int(np.asarray(act)[0])
            print(f"AI plays {divmod(a, g.size)} "
                  f"(value {float(root_value[0]):+.2f})")
        g.step(a)
    print(g.render())
    out = {1: "black (X) wins", -1: "white (O) wins", 0: "draw"}
    print(out[g.winner])


def _cmd_bench(cfg, args):
    import json as _json
    from alphafive_tpu.benchmarks import selfplay_bench
    if getattr(args, "mode", "selfplay") == "iteration":
        print(_json.dumps(selfplay_bench.run_iteration(cfg)))
    else:
        print(_json.dumps(selfplay_bench.run(cfg, plies=args.plies)))


if __name__ == "__main__":
    sys.exit(main())
