"""Ad-hoc perf experiment matrix for the MCTS hot path (run on the GPU).

Usage: python benchmarks/experiments.py
Prints one line per variant. Not part of the test suite.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alphafive_tpu.config import get_preset
from alphafive_tpu.benchmarks import selfplay_bench


def variant(cfg, **kw):
    env = kw.pop("num_envs", None)
    if env:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, num_envs=env))
    blocks = kw.pop("blocks", None)
    if blocks is not None:
        cfg = dataclasses.replace(
            cfg, net=dataclasses.replace(cfg.net, blocks=blocks))
    if kw:
        cfg = dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, **kw))
    return cfg


def main():
    base = get_preset("chip_15x15")
    variants = [
        ("base-256env-d64", base),
        ("1024env", variant(base, num_envs=1024)),
        ("2048env", variant(base, num_envs=2048)),
        ("d16", variant(base, max_depth=16)),
        ("blocks1", variant(base, blocks=1)),
        ("sims100", variant(base, num_simulations=100)),
        ("prior-bf16", variant(base, prior_dtype="bfloat16")),
    ]
    for name, cfg in variants:
        r = selfplay_bench.run(cfg, plies=4, warmup=1, repeats=2)
        print(f"{name:18s} steps/s={r['env_steps_per_s_per_chip']:8.1f} "
              f"sims/s={r['sims_per_s']:10.0f} "
              f"compile={r['compile_seconds']:5.1f}s", flush=True)


if __name__ == "__main__":
    main()
