"""Equal-budget strength A/B between two MCTS configurations.

Pits the SAME policy-value net under two search configs (A vs B) over
randomized openings, both color assignments (train/evaluate.py harness),
and also times each config's raw search so equal-WALL-CLOCK conclusions
can be drawn next to the equal-budget score (round-1 VERDICT items 1/3/5).

Usage (runs on the default accelerator; --platform cpu for small checks):

    python benchmarks/ab_strength.py --model pretrained/9x9 \
        --games 64 --sims 152 --opening-plies 6 \
        --a leaf_batch=8 --b leaf_batch=1

Prints one JSON line: score of A, W/D/L, and sims/s for both configs.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def apply_mcts_overrides(cfg, pairs):
    from alphafive_tpu.cli import _parse_override_value

    for ov in pairs:
        k, _, raw = ov.partition("=")
        val = _parse_override_value(raw, getattr(cfg, k))
        cfg = dataclasses.replace(cfg, **{k: val})
    return cfg


def time_search(env_cfg, mcts_cfg, evaluate, state, sims, key):
    import jax
    from alphafive_tpu.mcts import gumbel, search

    run = (gumbel.run_gumbel_mcts if mcts_cfg.root_selection == "gumbel"
           else search.run_mcts)
    fn = jax.jit(functools.partial(
        run, env_cfg, mcts_cfg, evaluate,
        num_simulations=sims, add_noise=False))
    jax.block_until_ready(fn(state, key).visits)  # compile + warm up
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(fn(state, key).visits)
        best = min(best, time.time() - t0)
    return state.board.shape[0] * sims / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="pretrained/9x9")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--sims", type=int, default=152)
    ap.add_argument("--sims-b", type=int, default=None,
                    help="budget for B (default: same as A)")
    ap.add_argument("--opening-plies", type=int, default=6)
    ap.add_argument("--a", action="append", default=[],
                    metavar="FIELD=VAL", help="MCTS overrides for side A")
    ap.add_argument("--b", action="append", default=[],
                    metavar="FIELD=VAL", help="MCTS overrides for side B")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from alphafive_tpu.config import MCTSConfig
    from alphafive_tpu.models.evaluator import net_evaluator
    from alphafive_tpu.train import checkpoint as ckpt
    from alphafive_tpu.train.evaluate import evaluate_vs, random_openings

    params, batch_stats, cfg = ckpt.load_model(args.model)
    env_cfg = cfg.env
    ev = net_evaluator(env_cfg, cfg.net, params, batch_stats)

    base = MCTSConfig()
    mcts_a = apply_mcts_overrides(base, args.a)
    mcts_b = apply_mcts_overrides(base, args.b)
    sims_b = args.sims_b or args.sims

    key = jax.random.key(args.seed)
    kt, kg = jax.random.split(key)
    probe = random_openings(env_cfg, max(args.games // 2, 2),
                            args.opening_plies, kt)
    sps_a = time_search(env_cfg, mcts_a, ev, probe, args.sims, kt)
    sps_b = time_search(env_cfg, mcts_b, ev, probe, sims_b, kt)

    t0 = time.time()
    res = evaluate_vs(env_cfg, base, ev, ev, args.sims, sims_b,
                      args.games, kg, mcts_a=mcts_a, mcts_b=mcts_b,
                      opening_plies=args.opening_plies)
    out = {
        "model": args.model,
        "board": env_cfg.board_size,
        "sims_a": args.sims, "sims_b": sims_b,
        "a": args.a, "b": args.b,
        **res,
        "sims_per_s_a": round(sps_a),
        "sims_per_s_b": round(sps_b),
        "speedup_a_over_b": round(sps_a / sps_b, 3),
        "match_seconds": round(time.time() - t0, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
