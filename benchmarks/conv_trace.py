"""Trace the net's convolutions on the GPU and report their roofline share.

Usage: python benchmarks/conv_trace.py [outdir]   (default chiprun_out/conv)

Two windows, each traced with jax.profiler after a warm-up call:

  * one chip_15x15 self-play chunk (2 plies: 2 x 50 passes, each one
    forward of 256 envs x 8 leaves = 2,048 boards);
  * one renju_19x19 forward at its leaf batch (512 envs x 8 = 4,096).

For each it prints the device time of the convolution kernels (kernel
events on the GPU plane's stream lines whose `hlo_op` stat names a
cuDNN convolution, `cudnn-conv...`), the convolutions' FLOPs computed from
the shapes, and their share of the bf16 roofline: (FLOPs / peak) / kernel
time. It also times one large bf16 matrix product for scale, and writes
each window's per-op totals to <outdir>/<window>_ops.txt.
"""

from __future__ import annotations

import collections
import functools
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.profiler import ProfileData  # noqa: E402

from alphafive_tpu.config import get_preset  # noqa: E402
from alphafive_tpu.env import vector  # noqa: E402
from alphafive_tpu.models.evaluator import net_evaluator  # noqa: E402
from alphafive_tpu.models.resnet import apply_eval  # noqa: E402
from alphafive_tpu.train import actor, learner  # noqa: E402

# Dense bf16 tensor-core peak by device kind (NVIDIA H100 SXM data sheet,
# without sparsity). A device missing here is an error, not a default.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def conv_flops(cfg, positions: int) -> float:
    """FLOPs (2 per multiply-add) of every convolution of one forward of
    `positions` boards: 3x3 stem and residual convs, 1x1 head convs."""
    a, c = cfg.env.num_actions, cfg.net.channels
    per_cell = 9 * (4 * c + 2 * cfg.net.blocks * c * c) + c * 3
    return 2.0 * positions * a * per_cell


def op_times(trace_dir: str):
    """{hlo op: total device ns of its kernels} over every line of the GPU
    planes, plus the line names seen (for reading a new trace by hand)."""
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    totals = collections.Counter()
    lines_seen = set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.add(f"{plane.name} :: {line.name}")
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op", ev.name)
                totals[op] += ev.duration_ns
    return totals, sorted(lines_seen)


def trace_window(name, fn, outdir, flops, peak):
    fn()  # compile + warm
    tdir = os.path.join(outdir, name)
    jax.profiler.start_trace(tdir)
    t0 = time.time()
    fn()
    wall = time.time() - t0
    jax.profiler.stop_trace()
    totals, lines = op_times(tdir)
    conv_ns = sum(ns for op, ns in totals.items()
                  if op.startswith("cudnn-conv"))
    all_ns = sum(totals.values())
    with open(os.path.join(outdir, f"{name}_ops.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        for op, ns in totals.most_common():
            f.write(f"{ns / 1e6:12.3f} ms  {op}\n")
    share = (flops / peak) / (conv_ns * 1e-9) if conv_ns else float("nan")
    print(f"{name}: wall {wall * 1e3:.1f} ms, device op time "
          f"{all_ns / 1e6:.1f} ms, conv kernels {conv_ns / 1e6:.2f} ms "
          f"({conv_ns / max(all_ns, 1):.1%} of op time), conv FLOPs "
          f"{flops:.4g}, achieved {flops / max(conv_ns * 1e-9, 1e-12) / 1e12:.1f}"
          f" TFLOP/s, roofline share {share:.1%} of {peak / 1e12:.0f} TFLOP/s",
          flush=True)
    for op, ns in totals.most_common(12):
        print(f"    {ns / 1e6:10.3f} ms  {op}")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/conv"
    os.makedirs(outdir, exist_ok=True)
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"device {dev.platform} {dev.device_kind}; nvidia-smi: "
          f"{smi.stdout.strip()}", flush=True)
    peak = PEAK_BF16_FLOPS[dev.device_kind]

    # scale: one large bf16 matrix product
    x = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda a: a @ a)
    mm(x).block_until_ready()
    t0 = time.time()
    for _ in range(10):
        y = mm(x)
    y.block_until_ready()
    dt = (time.time() - t0) / 10
    print(f"bf16 matmul 8192^3: {2 * 8192 ** 3 / dt / 1e12:.1f} TFLOP/s",
          flush=True)

    key = jax.random.key(0)

    # chip_15x15 self-play chunk, 2 plies: 2 x 50 passes of 256 x 8 boards
    cfg = get_preset("chip_15x15")
    boards = 2 * cfg.mcts.num_simulations * cfg.train.num_envs
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, key)
    evaluate = net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)
    chunk = jax.jit(functools.partial(actor.selfplay_chunk, cfg.env,
                                      cfg.mcts, evaluate, num_plies=2))
    state = vector.init(cfg.env, cfg.train.num_envs)
    trace_window("chip_15x15_chunk",
                 lambda: jax.block_until_ready(chunk(state, key)),
                 outdir, conv_flops(cfg, boards), peak)

    # renju_19x19 forward at its leaf batch, 512 x 8 boards
    cfg19 = get_preset("renju_19x19")
    batch = cfg19.train.num_envs * cfg19.mcts.leaf_batch
    ts = learner.init_train_state(cfg19.env, cfg19.net, cfg19.train, key)
    s = cfg19.env.board_size
    feats = (jax.random.uniform(key, (batch, s, s, 4)) < 0.1).astype(
        jnp.float32)
    fwd = jax.jit(functools.partial(apply_eval, cfg19.net))
    trace_window("renju_19x19_forward",
                 lambda: jax.block_until_ready(
                     fwd(ts.params, ts.batch_stats, feats)),
                 outdir, conv_flops(cfg19, batch), peak)


if __name__ == "__main__":
    main()
