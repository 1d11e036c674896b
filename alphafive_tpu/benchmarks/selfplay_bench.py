"""Self-play throughput benchmark (BASELINE.json:2 north-star metrics).

Measures env-steps/s/chip and MCTS sims/s for a full self-play chunk —
MCTS with batched net leaf evaluation, action sampling, env stepping,
auto-reset — i.e. the production hot path, not a microbenchmark.
"""

from __future__ import annotations

import functools
import time
from typing import Dict

import jax

from alphafive_tpu.config import RunConfig
from alphafive_tpu.env import vector
from alphafive_tpu.models.evaluator import net_evaluator
from alphafive_tpu.train import actor, learner


def run_iteration(cfg: RunConfig, warmup: int = 1, repeats: int = 3) -> Dict:
    """Benchmark the FULL actor-learner iteration (self-play chunk +
    replay write + learner steps) — BASELINE.json:9's "2048 envs + replay
    + learner on 1 host" measured as the production program, on however
    many devices are available (mesh.data clamped to the device count)."""
    from alphafive_tpu import parallel

    n = min(cfg.mesh.data, jax.device_count())
    cfg = cfg.replace(mesh=cfg.mesh.__class__(data=n))
    mesh = parallel.make_mesh(n)
    key = jax.random.key(0)
    carry = parallel.init_carry(cfg, key, mesh)
    iteration = parallel.make_train_iteration(cfg, mesh, donate=False)

    t_compile = time.time()
    carry, metrics = jax.block_until_ready(iteration(carry, key))
    compile_s = time.time() - t_compile
    for _ in range(warmup):
        carry, metrics = jax.block_until_ready(iteration(carry, key))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        carry, metrics = jax.block_until_ready(iteration(carry, key))
        best = min(best, time.time() - t0)

    env_steps = cfg.train.num_envs * cfg.train.selfplay_plies_per_iter
    sims = env_steps * cfg.mcts.num_simulations
    n_chips = mesh.devices.size
    return {
        "preset": cfg.name,
        "mode": "iteration",
        "board": cfg.env.board_size,
        "num_envs": cfg.train.num_envs,
        "num_simulations": cfg.mcts.num_simulations,
        "plies": cfg.train.selfplay_plies_per_iter,
        "learner_steps": cfg.train.learner_steps_per_iter,
        "chips": n_chips,
        "seconds": best,
        "compile_seconds": compile_s,
        "env_steps_per_s": env_steps / best,
        "env_steps_per_s_per_chip": env_steps / best / n_chips,
        "sims_per_s": sims / best,
        "updated": float(metrics["updated"]),
    }


def run(cfg: RunConfig, plies: int = 8, warmup: int = 1,
        repeats: int = 3) -> Dict:
    key = jax.random.key(0)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, key)
    env_state = vector.init(cfg.env, cfg.train.num_envs)
    evaluate = net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)

    fn = jax.jit(functools.partial(
        actor.selfplay_chunk, cfg.env, cfg.mcts, evaluate,
        num_plies=plies))

    t_compile = time.time()
    st, traj, stats = jax.block_until_ready(fn(env_state, key))
    compile_s = time.time() - t_compile

    for _ in range(warmup):
        st, traj, _ = jax.block_until_ready(fn(st, key))

    best = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        st, traj, _ = jax.block_until_ready(fn(st, key))
        best = min(best, time.time() - t0)

    n_chips = jax.device_count()
    env_steps = cfg.train.num_envs * plies
    sims = env_steps * cfg.mcts.num_simulations
    return {
        "preset": cfg.name,
        "board": cfg.env.board_size,
        "num_envs": cfg.train.num_envs,
        "num_simulations": cfg.mcts.num_simulations,
        "plies": plies,
        "chips": n_chips,
        "seconds": best,
        "compile_seconds": compile_s,
        "env_steps_per_s": env_steps / best,
        "env_steps_per_s_per_chip": env_steps / best / n_chips,
        "sims_per_s": sims / best,
        # one leaf evaluated per sim; forwards are batched leaf_batch-wide
        "leaf_evals_per_s": sims / best,
        "net_forwards_per_s": sims / best / max(cfg.mcts.leaf_batch, 1),
    }


def main(argv=None):
    """CLI: one JSON line of self-play (or full-iteration) throughput for
    any preset — the per-preset companion to the repo-root bench.py
    (which is pinned to the BASELINE.json:2 headline config)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="selfplay_bench")
    ap.add_argument("--preset", default="chip_15x15")
    ap.add_argument("--mode", choices=["selfplay", "iteration"],
                    default="selfplay")
    ap.add_argument("--plies", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from alphafive_tpu.config import get_preset
    cfg = get_preset(args.preset)
    if args.mode == "iteration":
        out = run_iteration(cfg, repeats=args.repeats)
    else:
        out = run(cfg, plies=args.plies, repeats=args.repeats)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
