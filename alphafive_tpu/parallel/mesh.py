"""The single SPMD actor-learner program over a `jax.sharding.Mesh`.

The reference has no distributed execution at all (SURVEY.md §2 parallelism
table: single-device training, per-game Python loops). The design here
(BASELINE.json north star, SURVEY.md §5.8):

  * One mesh axis ``data``. Env states and the replay ring are sharded over
    it; network params / optimizer state are replicated.
  * The whole iteration (self-play chunk → buffer write → K learner steps)
    is ONE ``shard_map``-ped, jit-compiled function. Inside, everything is
    device-local except the learner's gradient/batch-stat ``pmean`` — the
    only collective, an all-reduce across the mesh's devices.
  * Per-device RNG: the iteration key is folded with the device's mesh
    coordinate for env/sampling randomness, while the parameter update
    consumes only pmean'd quantities, keeping params bit-identical across
    devices.
  * Multi-host (BASELINE.json:10): the same program under
    ``jax.distributed.initialize`` + a global mesh — the driver validates
    the N-device path on a virtual CPU mesh (see __graft_entry__.py).

Self-play needs NO communication: every op is batched over envs, so XLA
partitions it trivially along ``data`` (the scaling-book recipe: annotate
shardings, let XLA insert collectives — here there are none to insert).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from alphafive_tpu.config import RunConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.models.evaluator import net_evaluator
from alphafive_tpu.models.resnet import apply_eval
from alphafive_tpu.replay import buffer as replay_buffer
from alphafive_tpu.replay.buffer import ReplayBuffer
from alphafive_tpu.train import actor, learner
from alphafive_tpu.train.learner import TrainState
from alphafive_tpu.utils import pytree

DATA_AXIS = "data"


@pytree.dataclass
class TrainCarry:
    train_state: TrainState   # replicated
    env_state: EnvState       # sharded over data (env axis)
    buffer: ReplayBuffer      # sharded over data (capacity axis)
    # one-chunk z-resolution lookahead (round 3, train/actor.py): the
    # previous chunk's raw recordings, staged E-major ([E, T, ...] so the
    # leading axis shards over `data` like env_state) until the next chunk
    # provides lookahead dones; has_pending is a per-device [n] flag that
    # gates the very first write (the zeroed staging buffer is not data)
    pending: actor.Recordings
    has_pending: jnp.ndarray


def make_mesh(num_data: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = num_data if num_data is not None else len(devices)
    assert n <= len(devices), f"mesh wants {n} devices, have {len(devices)}"
    return Mesh(np.asarray(devices[:n]).reshape(n), (DATA_AXIS,))


def init_carry(cfg: RunConfig, key: jax.Array, mesh: Mesh) -> TrainCarry:
    """Build the initial carry with proper shardings laid out on the mesh."""
    n = mesh.shape[DATA_AXIS]
    assert cfg.train.num_envs % n == 0, (cfg.train.num_envs, n)
    assert cfg.replay.capacity % n == 0
    assert cfg.replay.batch_size % n == 0

    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, key)
    env_state = vector.init(cfg.env, cfg.train.num_envs)
    buf = replay_buffer.init(cfg.env, cfg.replay)
    # per-shard ring pointers: ptr/size are per-device scalars -> keep them
    # as [n] arrays sharded over data so each shard runs an independent ring
    buf = buf.replace(ptr=jnp.zeros((n,), jnp.int32),
                      size=jnp.zeros((n,), jnp.int32))
    pending = jax.tree.map(
        lambda x: jnp.swapaxes(x, 0, 1),
        actor.init_recordings(cfg.env, cfg.train.selfplay_plies_per_iter,
                              cfg.train.num_envs))

    carry = TrainCarry(train_state=ts, env_state=env_state, buffer=buf,
                       pending=pending,
                       has_pending=jnp.zeros((n,), bool))
    return jax.device_put(carry, carry_shardings(mesh, carry))


def _spec_of(mesh: Mesh, x, leading_data: bool) -> NamedSharding:
    if leading_data and hasattr(x, "ndim") and x.ndim >= 1:
        return NamedSharding(mesh, P(DATA_AXIS, *([None] * (x.ndim - 1))))
    return NamedSharding(mesh, P())


def carry_shardings(mesh: Mesh, carry: TrainCarry) -> TrainCarry:
    data = lambda tree: jax.tree.map(
        lambda x: _spec_of(mesh, x, True), tree)
    return TrainCarry(
        train_state=jax.tree.map(lambda x: _spec_of(mesh, x, False),
                                 carry.train_state),
        env_state=data(carry.env_state),
        buffer=data(carry.buffer),
        pending=data(carry.pending),
        has_pending=_spec_of(mesh, carry.has_pending, True),
    )


def carry_pspecs(carry: TrainCarry) -> TrainCarry:
    """PartitionSpecs (for shard_map in/out) matching carry_shardings."""
    def data_spec(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            return P(DATA_AXIS, *([None] * (x.ndim - 1)))
        return P()
    data = lambda tree: jax.tree.map(data_spec, tree)
    return TrainCarry(
        train_state=jax.tree.map(lambda x: P(), carry.train_state),
        env_state=data(carry.env_state),
        buffer=data(carry.buffer),
        pending=data(carry.pending),
        has_pending=data_spec(carry.has_pending),
    )


def make_train_iteration(cfg: RunConfig, mesh: Mesh,
                         donate: bool = True) -> Callable:
    """Returns jitted `iteration(carry, key) -> (carry, metrics)`.

    One iteration = selfplay_plies_per_iter lockstep plies on every env +
    learner_steps_per_iter SGD steps (skipped until the buffer reaches
    min_fill). Metrics are host-ready scalars (replicated).

    Memoized on (cfg, mesh, donate): a second `train()` call in the same
    process (kill-and-resume, the smoke test's resume leg) gets the SAME jitted callable back and skips the
    ~10–20 s retrace + executable rebuild entirely.
    """
    return _make_train_iteration_cached(cfg, mesh, donate)


@functools.lru_cache(maxsize=8)
def _make_train_iteration_cached(cfg: RunConfig, mesh: Mesh,
                                 donate: bool) -> Callable:
    n = mesh.shape[DATA_AXIS]

    def _local_iteration(ts: TrainState, env_state: EnvState,
                         buf: ReplayBuffer, pending: actor.Recordings,
                         has_pending: jnp.ndarray, key: jax.Array):
        # --- per-device randomness; params stay replicated ---
        me = jax.lax.axis_index(DATA_AXIS)
        key = jax.random.fold_in(key, me)
        key, kplay, ksample = jax.random.split(key, 3)

        # buffer shard uses scalar ptr/size locally
        buf = buf.replace(ptr=buf.ptr[0], size=buf.size[0])

        # --- self-play chunk on the local envs ---
        evaluate = net_evaluator(cfg.env, cfg.net, ts.params, ts.batch_stats)
        env_state, recs, stats = actor.selfplay_record(
            cfg.env, cfg.mcts, evaluate, env_state, kplay,
            cfg.train.selfplay_plies_per_iter)

        # --- z-resolve the STAGED chunk with this chunk as lookahead and
        # write it into the local ring (one-chunk delay: games straddling
        # a chunk boundary still get value targets — actor.py docstring);
        # this chunk replaces it in the staging slot ---
        swap = lambda tree: jax.tree.map(
            lambda x: jnp.swapaxes(x, 0, 1), tree)
        traj = actor.resolve_chunk(cfg.env, swap(pending), lookahead=recs)
        # capture the gate BEFORE has_pending is reset below: the metric
        # must report 0 coverage on iteration 0 (nothing was written), not
        # the z_valid fraction of the zeroed staging buffer
        wrote = has_pending[0]
        buf = jax.lax.cond(
            wrote,
            lambda b: replay_buffer.write(
                b, traj.board, traj.to_play, traj.last_move, traj.pi,
                traj.z, traj.z_valid, traj.pi_valid),
            lambda b: b,
            buf)
        pending = swap(recs)
        has_pending = jnp.ones_like(has_pending)

        # --- K learner steps, gated on global fill ---
        global_size = jax.lax.psum(buf.size, DATA_AXIS)
        do_update = global_size >= cfg.replay.min_fill
        local_bs = cfg.replay.batch_size // n

        def learner_scan(ts, _):
            # probe batch for the reference-family KL-adaptive lr
            # (SURVEY.md §3.1: adapt the multiplier from KL(π_old‖π_new)
            # across the update phase)
            kprobe, kscan = jax.random.split(ksample)
            probe = replay_buffer.sample(cfg.env, buf, kprobe, local_bs)
            old_logits, _ = apply_eval(cfg.net, ts.params, ts.batch_stats,
                                       probe[0])
            old_logp = jax.nn.log_softmax(old_logits, axis=-1)
            p_old = jnp.exp(old_logp)

            def probe_kl(ts):
                logits, _ = apply_eval(cfg.net, ts.params, ts.batch_stats,
                                       probe[0])
                logp = jax.nn.log_softmax(logits, axis=-1)
                return jax.lax.pmean(
                    jnp.mean(jnp.sum(p_old * (old_logp - logp), axis=-1)),
                    DATA_AXIS)

            # KL early-stop (SURVEY.md §3.1, cfg.train.kl_stop_factor):
            # once the probe KL vs the phase-start policy exceeds
            # factor·kl_target, the remaining steps of the phase become
            # no-ops (the step that tripped the guard is kept — matching
            # the reference's break-after-epoch semantics)
            stop_thresh = cfg.train.kl_stop_factor * cfg.train.kl_target

            def one(carry, k):
                ts, stopped = carry
                batch = replay_buffer.sample(cfg.env, buf, k, local_bs)
                new_ts, aux = learner.train_step(
                    cfg.net, cfg.train, ts, batch,
                    axis_name=DATA_AXIS)
                if cfg.train.kl_stop_factor > 0:
                    tripped = probe_kl(new_ts) > stop_thresh
                else:
                    tripped = jnp.array(False)
                keep = lambda old, new: jax.tree.map(
                    lambda o, n_: jnp.where(stopped, o, n_), old, new)
                ts = keep(ts, new_ts)
                executed = (~stopped).astype(jnp.float32)
                aux = jax.tree.map(lambda x: x * executed, aux)
                aux["executed_steps"] = executed
                return (ts, stopped | tripped), aux
            ks = jax.random.split(kscan, cfg.train.learner_steps_per_iter)
            (ts, _), auxs = jax.lax.scan(one, (ts, jnp.array(False)), ks)

            # aux means over EXECUTED steps only (masked steps added zeros)
            n_exec = jnp.maximum(auxs["executed_steps"].sum(), 1.0)
            aux = jax.tree.map(lambda x: x.sum() / n_exec, auxs)
            aux["executed_steps"] = n_exec

            kl = probe_kl(ts)
            ts = learner.adapt_lr_scale(ts, kl, cfg.train.kl_target,
                                        cfg.train.lr_scale_max)
            aux["kl_update"] = kl
            return ts, aux

        def no_update(ts, _):
            zero_aux = {k: jnp.zeros(()) for k in
                        ("loss", "policy_loss", "value_loss", "l2_loss",
                         "kl_pi_p", "value_mae", "entropy_pi", "grad_norm",
                         "lr_scale", "kl_update", "executed_steps")}
            return ts, zero_aux

        ts, aux = jax.lax.cond(do_update, learner_scan, no_update, ts, None)

        metrics = dict(aux)
        metrics.update(
            games_finished=jax.lax.psum(
                stats.games_finished, DATA_AXIS).astype(jnp.float32),
            env_steps=jax.lax.psum(
                stats.env_steps, DATA_AXIS).astype(jnp.float32),
            black_wins=jax.lax.psum(
                stats.black_wins, DATA_AXIS).astype(jnp.float32),
            white_wins=jax.lax.psum(
                stats.white_wins, DATA_AXIS).astype(jnp.float32),
            draws=jax.lax.psum(stats.draws, DATA_AXIS).astype(jnp.float32),
            mean_root_value=jax.lax.pmean(stats.mean_root_value, DATA_AXIS),
            buffer_size=global_size.astype(jnp.float32),
            updated=do_update.astype(jnp.float32),
            step=ts.step.astype(jnp.float32),
            # value-target coverage of the chunk just written (the round-3
            # collapse forensics made this a first-class diagnostic)
            z_valid_frac=jax.lax.pmean(
                traj.z_valid.astype(jnp.float32).mean()
                * wrote.astype(jnp.float32), DATA_AXIS),
        )

        # restore per-shard ring pointer layout ([1] per device)
        buf = buf.replace(ptr=buf.ptr[None], size=buf.size[None])
        return ts, env_state, buf, pending, has_pending, metrics

    def iteration(carry: TrainCarry, key: jax.Array):
        pspecs = carry_pspecs(carry)
        f = shard_map(
            _local_iteration, mesh=mesh,
            in_specs=(pspecs.train_state, pspecs.env_state, pspecs.buffer,
                      pspecs.pending, pspecs.has_pending, P()),
            out_specs=(pspecs.train_state, pspecs.env_state, pspecs.buffer,
                       pspecs.pending, pspecs.has_pending, P()),
            check_vma=False,
        )
        ts, env_state, buf, pending, has_pending, metrics = f(
            carry.train_state, carry.env_state, carry.buffer,
            carry.pending, carry.has_pending, key)
        return (TrainCarry(train_state=ts, env_state=env_state, buffer=buf,
                           pending=pending, has_pending=has_pending),
                metrics)

    return jax.jit(iteration, donate_argnums=(0,) if donate else ())
