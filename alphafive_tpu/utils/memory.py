"""Order-of-magnitude per-device memory footprint estimate for a RunConfig.

Why this exists: a multi-device preset collapsed onto one device (e.g.
`multihost_15x15`'s 8,192 envs, meant for 8 devices) builds a program whose
tree arrays plus leaf-forward activations can far exceed one device's
memory, and nothing in the stock CLI stopped the invocation.
`estimate_device_bytes` is a crude, documented upper-bound-ish model of the
dominant allocations; the CLI refuses device runs whose estimate exceeds
the device's own allocator limit (`device_budget`) unless
`--allow-oversubscribe` is passed (cli.py).

This is an ESTIMATE for a guard, not an allocator: transient relayout
copies, XLA fusion slack, and donation behavior move real usage by tens
of percent.
"""

from __future__ import annotations

from alphafive_tpu.config import RunConfig


def device_budget(device) -> int:
    """Bytes the device's allocator may hand out (`bytes_limit` of its
    memory_stats). A device that reports no limit is an error: the guard
    assumes no size."""
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise SystemExit(
            f"device {device} reports no memory limit (memory_stats: "
            f"{sorted(stats)}); pass --allow-oversubscribe to skip the "
            f"memory guard")
    return int(stats["bytes_limit"])


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "int16": 2}[name]


def estimate_device_bytes(cfg: RunConfig, n_devices: int) -> int:
    """Dominant per-device allocations of the train/bench program."""
    e = -(-cfg.train.num_envs // max(n_devices, 1))  # envs per device
    a = cfg.env.num_actions
    nn = cfg.mcts.num_simulations + 1  # node pool (SURVEY.md §5.7)
    c = cfg.mcts.branch_cap or a

    # --- MCTS tree (mcts/search_capped.py init: slot arrays [E,NN,C] of
    # n/w/p/child/cand_act + per-node done/winner/last/count/board)
    slot = (2 + _dtype_bytes(cfg.mcts.value_dtype)
            + _dtype_bytes(cfg.mcts.prior_dtype) + 2 + 2)
    per_env_tree = nn * c * slot + nn * (1 + 1 + 4 + 4) + nn * a
    # select/backup relayouts double-buffer the big slot arrays
    tree = int(e * per_env_tree * 1.5)

    # --- leaf-forward activations: batch = E·leaf_batch positions through
    # the conv trunk; XLA keeps a few layer activations live at once
    batch = e * cfg.mcts.leaf_batch
    act = batch * a * cfg.net.channels * _dtype_bytes(
        cfg.net.compute_dtype) * 4

    # --- replay ring shard (replay/buffer.py: board int8 + pi bf16 + tags)
    replay = (cfg.replay.capacity // max(n_devices, 1)) * (3 * a + 3)

    # --- current + staged self-play chunk (train/actor.py Recordings:
    # board int8 + pi f32 + tags, ×2 for the one-chunk z lookahead)
    pending = 2 * cfg.train.selfplay_plies_per_iter * e * (5 * a + 3)

    # --- params + opt state + grads (tiny nets; flat fudge)
    params = 64_000_000

    return tree + act + replay + pending + params


def budget_error(cfg: RunConfig, n_devices: int, budget: int):
    """Refusal message if the estimate busts the budget, else None."""
    est = estimate_device_bytes(cfg, n_devices)
    if est <= budget:
        return None
    return (
        f"refusing to run: estimated per-device footprint "
        f"{est / 1e9:.1f} GB over {n_devices} device(s) exceeds the "
        f"{budget / 1e9:.1f} GB device memory budget "
        f"(preset {cfg.name!r} wants mesh.data={cfg.mesh.data}). "
        f"Shrink train.num_envs / replay for this device count — "
        f"for multi-device presets bench the per-device shard (e.g. "
        f"--set mesh.data=1 --set train.num_envs="
        f"{cfg.train.num_envs // max(cfg.mesh.data, 1)}) — or pass "
        f"--allow-oversubscribe to override (utils/memory.py).")
