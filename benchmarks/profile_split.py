"""Split self-play time into MCTS machinery vs net forward (run on the GPU).

Usage: python benchmarks/profile_split.py
Prints three lines: combined chunk, uniform-evaluator chunk (MCTS-only),
and bare net forwards at the same eval count.
"""

from __future__ import annotations

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from alphafive_tpu.config import get_preset
from alphafive_tpu.env import vector
from alphafive_tpu.models.evaluator import net_evaluator, uniform_evaluator
from alphafive_tpu.models.resnet import apply_eval
from alphafive_tpu.train import actor, learner

PLIES = 4


def timeit(fn, *args, warmup=1, repeats=3):
    out = fn(*args)
    jax.block_until_ready(out)
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.time() - t0)
    return best


def main():
    cfg = get_preset("chip_15x15")
    key = jax.random.key(0)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, key)
    env_state = vector.init(cfg.env, cfg.train.num_envs)

    for name, ev in [
        ("net", net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)),
        ("uniform", uniform_evaluator(cfg.env)),
    ]:
        fn = jax.jit(functools.partial(
            actor.selfplay_chunk, cfg.env, cfg.mcts, ev, num_plies=PLIES))
        best = timeit(lambda: fn(env_state, key))
        steps = cfg.train.num_envs * PLIES
        print(f"chunk[{name:7s}] {best:6.3f}s  "
              f"steps/s={steps / best:8.1f}", flush=True)

    # bare net forwards: sims * plies batched evals of [E, S, S, 4]
    x = jnp.zeros((cfg.train.num_envs, cfg.env.board_size,
                   cfg.env.board_size, 4), jnp.float32)
    n_evals = cfg.mcts.num_simulations * PLIES

    @jax.jit
    def forwards(x):
        # acc feeds back into the input so XLA cannot hoist the forward
        # out of the loop as loop-invariant
        def body(i, acc):
            logits, v = apply_eval(cfg.net, ts.params, ts.batch_stats,
                                   x + acc * 1e-20)
            return logits.sum() * 1e-20 + v.sum() * 1e-20
        return jax.lax.fori_loop(0, n_evals, body, 0.0)

    best = timeit(lambda: forwards(x))
    print(f"net-only {n_evals} evals: {best:6.3f}s  "
          f"evals/s={n_evals / best:8.1f}", flush=True)


if __name__ == "__main__":
    main()
