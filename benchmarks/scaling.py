"""Weak-scaling efficiency harness (BASELINE.json metric: 1→N scaling).

Runs the full sharded train iteration (self-play chunk + replay write +
learner steps, parallel/mesh.py) on meshes of 1..N devices with envs scaled
proportionally (weak scaling) and reports per-device env-steps/s and the
efficiency vs the 1-device run.

With --platform cpu the run uses a virtual CPU mesh
(xla_force_host_platform_device_count) — that validates the SPMD program's
scaling *structure* (all collectives, sharding and donation compile and
execute); the absolute numbers are CPU numbers. On a GPU host the same
harness measures real scaling over the host's GPUs.

Usage: python benchmarks/scaling.py [--platform cpu] [--devices 1,2,4,8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--preset", default="tiny_test")
    ap.add_argument("--envs-per-device", type=int, default=8)
    ap.add_argument("--plies", type=int, default=8)
    args = ap.parse_args()

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices",
                          max(int(d) for d in args.devices.split(",")))

    from alphafive_tpu import parallel
    from alphafive_tpu.config import get_preset

    base = None
    results = []
    for n in [int(d) for d in args.devices.split(",")]:
        cfg = get_preset(args.preset)
        cfg = dataclasses.replace(
            cfg,
            mesh=dataclasses.replace(cfg.mesh, data=n),
            train=dataclasses.replace(
                cfg.train, num_envs=args.envs_per_device * n,
                selfplay_plies_per_iter=args.plies),
            replay=dataclasses.replace(
                cfg.replay, capacity=4096 * n,
                batch_size=32 * n, min_fill=64),
        )
        mesh = parallel.make_mesh(n)
        carry = parallel.init_carry(cfg, jax.random.key(0), mesh)
        it = parallel.make_train_iteration(cfg, mesh)
        carry, m = it(carry, jax.random.key(1))
        jax.block_until_ready(m)
        t0 = time.time()
        reps = 3
        for r in range(reps):
            carry, m = it(carry, jax.random.key(2 + r))
        jax.block_until_ready(m)
        dt = (time.time() - t0) / reps
        steps = cfg.train.num_envs * args.plies
        per_dev = steps / dt / n
        if base is None:
            base = per_dev
        results.append({
            "devices": n,
            "env_steps_per_s": round(steps / dt, 1),
            "env_steps_per_s_per_device": round(per_dev, 1),
            "scaling_efficiency": round(per_dev / base, 4),
        })
        print(json.dumps(results[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
