"""Full-state checkpoint/resume on plain numpy files (SURVEY.md §5.3/§5.4).

The reference checkpoints net weights only (`tf.train.Saver`); buffer and
step state are lost on restart. Here the WHOLE training state is captured —
params, optimizer state, batch stats, env states, the replay ring, the PRNG
key, iteration counter, and the Elo ladder — so a resume is bit-reproducible
(SURVEY.md §5.4). Config is serialized alongside every checkpoint.

Layout of one step, ``<directory>/<step>/``:

  * ``shards_<p>.npz`` — written by process ``p``: every addressable shard
    with replica id 0 of every carry leaf, keyed ``<leaf path>@<slices>``;
  * ``meta.json`` — written by the primary: iteration, config, ladder, the
    PRNG key data, and each leaf's global shape and dtype.

All processes write into ``<directory>/.<step>.tmp/``; the primary renames
it to ``<step>`` once every process has written, so a step directory
appears only complete. The directory must be shared by all processes. The
newest ``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

from alphafive_tpu.config import RunConfig
from alphafive_tpu.parallel import distributed
from alphafive_tpu.parallel.mesh import TrainCarry
from alphafive_tpu.utils import pytree
from alphafive_tpu.utils.elo import LadderState


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    directory: str
    max_to_keep: int = 3

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(os.path.abspath(directory), max_to_keep)


def _leaf_name(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator="/")


def _bounds(index, shape) -> Tuple[Tuple[int, int], ...]:
    """Per-dimension (start, stop) of a shard index (a tuple of slices)."""
    return tuple((s.start or 0, n if s.stop is None else s.stop)
                 for s, n in zip(index, shape))


def _slices_name(index, shape) -> str:
    return ",".join(f"{a}:{b}" for a, b in _bounds(index, shape))


def _parse_slices(name: str) -> Tuple[Tuple[int, int], ...]:
    return tuple(tuple(int(v) for v in s.split(":"))
                 for s in name.split(",") if s)


def _to_numpy(x) -> np.ndarray:
    """npz keeps only numpy's own dtypes: store bfloat16 as raw uint16."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jax.numpy.bfloat16 else x


def save(mgr: CheckpointManager, iteration: int, carry: TrainCarry,
         key: jax.Array, cfg: RunConfig, ladder: LadderState,
         extra: Optional[Dict[str, Any]] = None) -> None:
    """Write step `iteration`. Every process must call it (multi-host)."""
    tmp = os.path.join(mgr.directory, f".{iteration}.tmp")
    primary = distributed.is_primary()
    if primary:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    distributed.barrier(f"ckpt-{iteration}-open")

    shards, leaves = {}, {}
    for path, x in jax.tree_util.tree_flatten_with_path(carry)[0]:
        name = _leaf_name(path)
        leaves[name] = {"shape": list(x.shape), "dtype": str(x.dtype)}
        for s in x.addressable_shards:
            if s.replica_id == 0:
                shards[f"{name}@{_slices_name(s.index, x.shape)}"] = (
                    _to_numpy(s.data))
    np.savez(os.path.join(tmp, f"shards_{jax.process_index()}.npz"),
             **shards)
    distributed.barrier(f"ckpt-{iteration}-written")

    if primary:
        meta = {
            "config": cfg.to_json(),
            "ladder": json.dumps(dataclasses.asdict(ladder)),
            "iteration": iteration,
            "key": np.asarray(jax.random.key_data(key)).tolist(),
            "leaves": leaves,
            **(extra or {}),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = mgr.step_dir(iteration)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in mgr.all_steps()[:-mgr.max_to_keep]:
            shutil.rmtree(mgr.step_dir(old), ignore_errors=True)
    distributed.barrier(f"ckpt-{iteration}-done")


def _ladder_from_dict(lad: Dict[str, Any]) -> LadderState:
    """Rebuild LadderState tolerating fields added after a save (e.g.
    max_rollouts — ADVICE.md round-1: dropping it silently reverted a
    customized anchor cap on resume)."""
    defaults = LadderState()
    return LadderState(
        level=lad["level"],
        base_rollouts=lad["base_rollouts"],
        promote_score=lad["promote_score"],
        max_rollouts=lad.get("max_rollouts", defaults.max_rollouts),
        history=lad["history"])


def _read_meta_dict(mgr: CheckpointManager, iteration: Optional[int]):
    step = iteration if iteration is not None else mgr.latest_step()
    assert step is not None, "no checkpoint found"
    with open(os.path.join(mgr.step_dir(step), "meta.json")) as f:
        return step, json.load(f)


def read_meta(mgr: CheckpointManager, iteration: Optional[int] = None):
    """(iteration, RunConfig, LadderState) of a checkpoint's metadata."""
    _, meta = _read_meta_dict(mgr, iteration)
    cfg = RunConfig.from_json(meta["config"])
    ladder = _ladder_from_dict(json.loads(meta["ladder"]))
    return int(meta["iteration"]), cfg, ladder


def _assemble(name: str, want, pieces, dtype) -> np.ndarray:
    """Block `want` (per-dimension (start, stop)) of leaf `name`, read from
    the saved pieces that overlap it. Raises unless they cover it exactly
    (a missing shard file or piece would otherwise leave a gap)."""
    out = np.empty(tuple(b - a for a, b in want), dtype)
    filled = []
    for box, f, k in pieces:
        part = tuple((max(a, c), min(b, d))
                     for (a, b), (c, d) in zip(box, want))
        if any(a >= b for a, b in part):
            continue
        if any(all(max(a, c) < min(b, d)
                   for (a, b), (c, d) in zip(part, other))
               for other in filled):
            raise ValueError(f"checkpoint leaf {name}: saved pieces overlap")
        data = f[k].view(dtype)
        if data.shape != tuple(b - a for a, b in box):
            raise ValueError(f"checkpoint leaf {name}: piece {k} has shape "
                             f"{data.shape}")
        dst = tuple(slice(a - w, b - w) for (a, b), (w, _) in zip(part, want))
        src = tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(part, box))
        out[dst] = data[src]
        filled.append(part)
    covered = sum(int(np.prod([b - a for a, b in part])) for part in filled)
    if covered != out.size:
        raise ValueError(f"checkpoint leaf {name}: the saved shards cover "
                         f"{covered} of the {out.size} elements of block "
                         f"{list(want)}; a shard file is missing")
    return out


def _load_leaves(step_dir: str, meta, like):
    """Rebuild every leaf of `like` (a pytree of jax.Arrays) from the step's
    shard files, laid out with the leaf's own sharding. Each process reads
    only the pieces that overlap its own devices' shards."""
    files = []
    pieces: Dict[str, list] = {}

    def load(path, target):
        name = _leaf_name(path)
        shape = tuple(meta["leaves"][name]["shape"])
        if shape != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {name} has shape {shape}, "
                             f"expected {tuple(target.shape)}")
        blocks = {}  # replicated shards ask for the same block repeatedly

        def block(index):
            want = _bounds(index, shape)
            if want not in blocks:
                blocks[want] = _assemble(name, want, pieces.get(name, []),
                                         target.dtype)
            return blocks[want]

        return jax.make_array_from_callback(shape, target.sharding, block)

    try:
        for n in sorted(os.listdir(step_dir)):
            if n.endswith(".npz"):
                files.append(np.load(os.path.join(step_dir, n)))
                for k in files[-1].files:
                    name, _, slices = k.partition("@")
                    pieces.setdefault(name, []).append(
                        (_parse_slices(slices), files[-1], k))
        return jax.tree_util.tree_map_with_path(load, like)
    finally:
        for f in files:
            f.close()


def restore(mgr: CheckpointManager, carry_like: TrainCarry,
            iteration: Optional[int] = None
            ) -> Tuple[int, TrainCarry, jax.Array, RunConfig, LadderState]:
    """(iteration, carry, key, cfg, ladder) of a step, the carry laid out
    like `carry_like` (same shapes; any sharding)."""
    step, meta = _read_meta_dict(mgr, iteration)
    carry = _load_leaves(mgr.step_dir(step), meta, carry_like)
    cfg = RunConfig.from_json(meta["config"])
    ladder = _ladder_from_dict(json.loads(meta["ladder"]))
    key = jax.random.wrap_key_data(np.asarray(meta["key"], np.uint32))
    return int(meta["iteration"]), carry, key, cfg, ladder


def restore_train_state(mgr: CheckpointManager,
                        iteration: Optional[int] = None):
    """Model-only restore that works from ANY preset: rebuilds the train
    state from the checkpoint's own saved config (optimizer shapes must
    match what was saved, not the caller's preset), then returns
    (train_state, saved_cfg)."""
    from alphafive_tpu.train import learner

    step, meta = _read_meta_dict(mgr, iteration)
    cfg = RunConfig.from_json(meta["config"])
    like = TrainCarry(
        train_state=learner.init_train_state(cfg.env, cfg.net, cfg.train,
                                             jax.random.key(0)),
        env_state=None, buffer=None, pending=None, has_pending=None)
    return _load_leaves(mgr.step_dir(step), meta, like).train_state, cfg


# --- lightweight model export (the distributable "pretrained model") ----
#
# The reference ships a ready-to-play checkpoint in-repo (SURVEY.md §2
# "Pretrained model"). Full training checkpoints embed env/replay state
# whose shapes depend on the training preset, so the bundled artifact is
# params-only: <dir>/model.npz (flat "params/..." and "batch_stats/..."
# float32 arrays) + <dir>/config.json.

MODEL_FILE = "model.npz"


def export_model(directory: str, params, batch_stats, cfg: RunConfig,
                 extra: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for prefix, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[f"{prefix}/{_leaf_name(path)}"] = np.asarray(
                jax.device_get(leaf))
    np.savez(os.path.join(directory, MODEL_FILE), **flat)
    meta = {"config": json.loads(cfg.to_json()), **(extra or {})}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_model(directory: str):
    """(params, batch_stats, RunConfig) from an export_model directory."""
    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    cfg = RunConfig.from_json(json.dumps(meta["config"]))
    with np.load(os.path.join(directory, MODEL_FILE)) as f:
        out = pytree.unflatten({k: jax.numpy.asarray(f[k]) for k in f.files})
    return out["params"], out.get("batch_stats", {}), cfg
