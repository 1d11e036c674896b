"""Smoke run of the self-play trainer's main path on the GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the data-parallel path

Phases, each printed with its compile seconds (lowering + XLA compile, as
JAX's monitoring events report them), the rest of its wall seconds, and the
device's peak bytes in use since start:

  device  the device JAX reports and nvidia-smi's name and power limit;
  parity  bundled nets at real widths and leaf batches: the production bf16
          forward against a float32 reference at highest matmul precision,
          and the float32 forward of every bundle against the golden
          fixture recorded with the original implementation;
  search  the exact search against the NumPy oracle (equal visit counts),
          and the chip_15x15 production search on the GPU against the same
          search on the CPU, with one deterministic evaluator;
  train   `cli train --preset chip_15x15`: two iterations (the learner
          updates on the second), a checkpoint, a resume for one more;
  bench   `cli bench --preset renju_19x19 --plies 2` and `cli eval --preset
          renju_19x19 --games 2 --anchor-rollouts 200`, which plays the
          bundled 19x19_10b net.

`--four-cards` runs only `cli train --preset host_15x15` for three
iterations on four GPUs, checks that the parameters are bit-identical on
every device, and compares one learner step on a global batch sharded over
four devices with the same step on one device.

Runs in one process. The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}};
with no GPU, or when any phase fails, the script exits nonzero and prints
no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# The search phase compares the GPU with the CPU, so keep the CPU backend
# when the environment names the platforms (the GPU stays the default).
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphafive_tpu import cli  # noqa: E402
from alphafive_tpu.config import EnvConfig, MCTSConfig, get_preset  # noqa: E402
from alphafive_tpu.env import vector  # noqa: E402
from alphafive_tpu.mcts import reference, search  # noqa: E402
from alphafive_tpu.models.resnet import apply_eval  # noqa: E402
from alphafive_tpu.train import checkpoint as ckpt  # noqa: E402
from alphafive_tpu.utils import pytree  # noqa: E402
from tests.helpers import (frozen_net_evaluator, jax_eval,  # noqa: E402
                           np_eval, random_midgame, to_env_state)

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden_net.npz")

# Tolerances, each with its reason.
# bf16 production forward vs float32 reference: bf16 keeps 8 significant
# bits (relative rounding 2^-9 per operation) and the 10-block tower chains
# 21 convs and BatchNorms, so softmax probabilities and tanh values drift by
# up to a few 1e-2; a wrong layout or a lost BatchNorm moves them by O(1).
BF16_PROB_TOL = 0.05
BF16_VALUE_TOL = 0.1
# float32 forward at highest precision vs the fixture (recorded on the CPU
# at highest precision): only the order of the float32 sums differs, which
# moves logits by ~1e-5 on the H100. Same tolerance as the CPU test of the
# fixture. Without a precision setting the GPU would run float32 matrix
# products in TF32 (10-bit mantissa, ~1e-3 relative per product), an order
# of magnitude outside it.
GOLDEN_ATOL = 1e-4
GOLDEN_RTOL = 1e-4
# chip_15x15 search, GPU vs CPU: the tree statistics are integers (int16
# fixed-point value sums) and the search's own matrix products run at
# highest precision, so the two devices differ only in the last bit of the
# evaluator's float math (exp, tanh, matrix products) — which can still
# flip a near-tie between two root moves, rarely.
ARGMAX_AGREE_MIN = 0.98
# one learner step, 4 devices vs 1, with the net in float32 at highest
# precision so that bf16 rounding does not mask the data-parallel math:
# only the order of the per-shard sums and of the cross-device mean
# differs.
STEP_ATOL = 1e-5
STEP_RTOL = 1e-4

_COMPILE_EVENTS = ("/jax/core/compile/backend_compile_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration")


class CompileClock:
    """Seconds JAX spent lowering and compiling, from its monitoring
    events (a persistent-cache hit counts as the compile it replaced)."""

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.seconds += duration


def require(ok, what):
    """A failed check fails the script (asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_phase(clock, name, fn, *args, **kwargs):
    """Run one phase; print its timings and peak memory. Failures propagate:
    a failed phase fails the script."""
    c0, t0 = clock.seconds, time.time()
    out = fn(*args, **kwargs)
    wall = time.time() - t0
    compile_s = clock.seconds - c0
    print(f"[{name}] compile_s={compile_s:.1f} run_s={wall - compile_s:.1f} "
          f"peak_bytes_in_use={_peak_bytes()} "
          f"result={json.dumps(out, default=float)}", flush=True)
    return out


def _cli(argv):
    """Run one CLI command in this process; returns its stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, (argv, rc))
    return buf.getvalue().splitlines()


# --- device -----------------------------------------------------------------

def phase_device():
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    for ln in lines:
        print(f"nvidia-smi: {ln}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": lines}


# --- parity -----------------------------------------------------------------

def random_positions(env_cfg: EnvConfig, n: int, seed: int):
    """n positions with 0..A/3 random alternating stones (features only
    need legal-looking boards; terminal ones are fine for a forward)."""
    rng = np.random.default_rng(seed)
    a = env_cfg.num_actions
    boards = np.zeros((n, a), np.int8)
    counts = rng.integers(0, a // 3, size=n)
    order = np.argsort(rng.random((n, a)), axis=1)
    colors = np.where(np.arange(a) % 2 == 0, 1, -1).astype(np.int8)
    for i in range(n):
        boards[i, order[i, :counts[i]]] = colors[:counts[i]]
    to_play = np.where(counts % 2 == 0, 1, -1).astype(np.int8)
    last = np.where(counts > 0, order[np.arange(n), np.maximum(counts - 1, 0)],
                    -1).astype(np.int32)
    return vector.features(env_cfg, jnp.asarray(boards),
                           jnp.asarray(to_play), jnp.asarray(last))


def _as_f32(net):
    return dataclasses.replace(net, compute_dtype="float32")


def phase_parity(bundles, golden_path=GOLDEN):
    """bundles: [(bundle name, batch)] compared bf16 vs float32 at that
    batch; every bundle in the fixture is compared with it in float32."""
    out = {}
    for name, batch in bundles:
        params, bs, cfg = ckpt.load_model(os.path.join(REPO, "pretrained",
                                                       name))
        feats = random_positions(cfg.env, batch, seed=batch)
        prod = jax.jit(functools.partial(apply_eval, cfg.net))
        ref = jax.jit(functools.partial(apply_eval, _as_f32(cfg.net)))
        lg, v = prod(params, bs, feats)
        with jax.default_matmul_precision("highest"):
            lg_ref, v_ref = ref(params, bs, feats)
        prob_diff = float(jnp.max(jnp.abs(jax.nn.softmax(lg, -1)
                                          - jax.nn.softmax(lg_ref, -1))))
        value_diff = float(jnp.max(jnp.abs(v - v_ref)))
        require(lg.shape == (batch, cfg.env.num_actions), lg.shape)
        require(bool(jnp.isfinite(lg).all()) and bool(jnp.isfinite(v).all()),
                f"{name}: non-finite outputs")
        print(f"  {name} batch {batch}: bf16 vs float32 max |dprob| "
              f"{prob_diff:.3g} (tol {BF16_PROB_TOL}), max |dvalue| "
              f"{value_diff:.3g} (tol {BF16_VALUE_TOL})", flush=True)
        require(prob_diff <= BF16_PROB_TOL and value_diff <= BF16_VALUE_TOL,
                f"{name}: bf16 forward outside tolerance")
        out[name] = {"batch": batch, "prob_diff": prob_diff,
                     "value_diff": value_diff}

    golden = pytree.unflatten(dict(np.load(golden_path)))
    for name, g in sorted(golden["bundle"].items()):
        params, bs, cfg = ckpt.load_model(os.path.join(REPO, "pretrained",
                                                       name))
        feats = vector.features(cfg.env, jnp.asarray(g["board"]),
                                jnp.asarray(g["to_play"]),
                                jnp.asarray(g["last"]))
        with jax.default_matmul_precision("highest"):
            lg, v = jax.jit(functools.partial(apply_eval, _as_f32(cfg.net)))(
                params, bs, feats)
        d_lg = float(np.max(np.abs(np.asarray(lg) - g["logits_float32"])))
        d_v = float(np.max(np.abs(np.asarray(v) - g["value_float32"])))
        print(f"  {name} float32 vs golden: max |dlogit| {d_lg:.3g}, "
              f"max |dvalue| {d_v:.3g} (atol {GOLDEN_ATOL}, rtol "
              f"{GOLDEN_RTOL})", flush=True)
        np.testing.assert_allclose(np.asarray(lg), g["logits_float32"],
                                   atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL)
        np.testing.assert_allclose(np.asarray(v), g["value_float32"],
                                   atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL)
        out[f"golden/{name}"] = {"logit_diff": d_lg, "value_diff": d_v}
    return out


# --- search -----------------------------------------------------------------

def live_games(size, n_in_row, n, max_plies, seed):
    """n live games, each after 0..max_plies random moves."""
    rng = np.random.default_rng(seed)
    return [random_midgame(size, n_in_row,
                           int(rng.integers(0, max_plies + 1)), seed + 50 * i)
            for i in range(n)]


def phase_search(oracle_size=9, oracle_sims=50, oracle_envs=4,
                 preset="chip_15x15", num_envs=None, plies=30):
    # (1) exact search (branch_cap=None, leaf_batch=1) vs the NumPy oracle
    env_cfg = EnvConfig(board_size=oracle_size, n_in_row=5)
    mcts_cfg = MCTSConfig(num_simulations=oracle_sims)
    games = live_games(oracle_size, 5, oracle_envs, 10, seed=1)
    res = jax.jit(functools.partial(search.run_mcts, env_cfg, mcts_cfg,
                                    jax_eval(oracle_size), add_noise=False))(
        to_env_state(games), jax.random.key(0))
    visits = np.asarray(res.visits)
    for i, g in enumerate(games):
        ref_n, _ = reference.run_mcts_reference(
            g, np_eval(oracle_size), oracle_sims, c_puct=mcts_cfg.c_puct,
            root_noise=None)
        np.testing.assert_array_equal(visits[i], ref_n, err_msg=f"env {i}")
    out = {"oracle_envs": len(games), "oracle_visits_equal": True}

    # (2) production search on the default device vs the CPU
    cfg = get_preset(preset)
    e = num_envs or cfg.train.num_envs
    games = live_games(cfg.env.board_size, cfg.env.n_in_row, e, plies,
                       seed=100)
    evaluate = frozen_net_evaluator(cfg.env, jax.random.key(7))
    run = functools.partial(search.run_mcts, cfg.env, cfg.mcts, evaluate,
                            add_noise=False)
    state = to_env_state(games)
    moves = {}
    for name, dev in (("default", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        st = jax.device_put(state, dev)
        key = jax.device_put(jax.random.key(0), dev)
        r = jax.jit(run)(st, key)
        require(np.asarray(r.visits).sum(-1).min() > 0,
                f"{name}: a root with no visits")
        moves[name] = np.asarray(jnp.argmax(r.visits, -1))
    agree = float(np.mean(moves["default"] == moves["cpu"]))
    print(f"  {preset} search, {e} envs: root argmax agreement "
          f"{jax.devices()[0].platform} vs cpu {agree:.4f} "
          f"(min {ARGMAX_AGREE_MIN})", flush=True)
    require(agree >= ARGMAX_AGREE_MIN, f"argmax agreement {agree}")
    out.update(production_envs=e, argmax_agreement=agree)
    return out


# --- train, bench, eval ------------------------------------------------------

def _metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(preset, workdir, extra=()):
    """Two iterations (the learner updates on the second), a checkpoint at
    2, then a resume that runs iteration 3."""
    base = ["train", "--preset", preset, "--workdir", workdir,
            "--set", "train.checkpoint_every_iters=2", *extra]
    _cli(base + ["--iters", "2"])
    _cli(base + ["--iters", "3", "--resume"])
    rows = _metrics(workdir)
    iters = [r for r in rows if r["kind"] == "iter"]
    require([r["iter"] for r in iters] == [0, 1, 2], iters)
    require([r["updated"] for r in iters] == [0.0, 1.0, 1.0], iters)
    require(all(np.isfinite(r["loss"]) for r in iters), iters)
    require([r["iter"] for r in rows if r["kind"] == "resume"] == [2],
            "no resume at iteration 2")
    mgr = ckpt.make_manager(os.path.join(workdir, "ckpt"))
    require(mgr.all_steps() == [2, 3], mgr.all_steps())
    return {"losses": [r["loss"] for r in iters],
            "iter_seconds": [r["iter_seconds"] for r in iters],
            "checkpoints": mgr.all_steps()}


def phase_bench_eval(preset, plies, games, anchor_rollouts, extra=()):
    bench = json.loads(_cli(["bench", "--preset", preset, "--plies",
                             str(plies), *extra])[-1])
    require(bench["env_steps_per_s"] > 0, bench)
    model = cli._pretrained_dir(get_preset(preset))
    ev = json.loads(_cli(["eval", "--preset", preset, "--games", str(games),
                          "--anchor-rollouts", str(anchor_rollouts),
                          *extra])[-1])
    require(ev["games"] == games and 0.0 <= ev["score"] <= 1.0, ev)
    return {"bench": bench, "eval": ev,
            "eval_model": model and os.path.basename(model)}


# --- four cards ---------------------------------------------------------------

def _replicas_identical(tree):
    for leaf in jax.tree.leaves(tree):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            if not np.array_equal(shards[0], s):
                return False
    return True


def _learner_step_compare(cfg, n):
    """One learner step on a fixed global batch: sharded over n devices
    (shard_map, gradient pmean) vs the same per-shard math on one device
    (vmap over n shards with the same axis name)."""
    from jax.sharding import PartitionSpec as P

    from alphafive_tpu import parallel
    from alphafive_tpu.train import learner

    net = _as_f32(cfg.net)
    ts = learner.init_train_state(cfg.env, net, cfg.train,
                                  jax.random.key(3))
    b, a, s = cfg.replay.batch_size, cfg.env.num_actions, cfg.env.board_size
    k1, k2, k3 = jax.random.split(jax.random.key(4), 3)
    batch = (random_positions(cfg.env, b, seed=5),
             jax.nn.softmax(jax.random.normal(k1, (b, a)), -1),
             jnp.sign(jax.random.normal(k2, (b,))),
             (jax.random.uniform(k3, (b,)) < 0.7).astype(jnp.float32),
             jnp.ones((b,), jnp.float32))
    require(batch[0].shape == (b, s, s, 4), batch[0].shape)
    step = functools.partial(learner.train_step, net, cfg.train,
                             axis_name=parallel.mesh.DATA_AXIS)
    mesh = parallel.make_mesh(n)
    with jax.default_matmul_precision("highest"):
        sharded = jax.jit(jax.shard_map(
            step, mesh=mesh, in_specs=(P(), P(parallel.mesh.DATA_AXIS)),
            out_specs=(P(), P()), check_vma=False))(ts, batch)
        chunks = jax.tree.map(lambda x: x.reshape(n, b // n, *x.shape[1:]),
                              batch)
        single = jax.jit(jax.vmap(lambda c: step(ts, c),
                                  axis_name=parallel.mesh.DATA_AXIS))(chunks)
    single = jax.tree.map(lambda x: x[0], single)
    worst = 0.0
    for x, y in zip(jax.tree.leaves(sharded), jax.tree.leaves(single)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        np.testing.assert_allclose(x, y, atol=STEP_ATOL, rtol=STEP_RTOL)
        worst = max(worst, float(np.max(np.abs(x - y), initial=0.0)))
    print(f"  learner step {n} devices vs 1: max |diff| {worst:.3g} over "
          f"params, Adam moments, BN stats and losses (atol {STEP_ATOL}, "
          f"rtol {STEP_RTOL})", flush=True)
    return worst


def phase_four_cards(preset, workdir, n=4, iters=3, extra=()):
    import alphafive_tpu.train.loop as loop

    captured = {}
    train = loop.train

    def capture(*args, **kwargs):
        captured["carry"], _ = out = train(*args, **kwargs)
        return out

    loop.train = capture  # cli.main imports loop.train when it runs
    try:
        _cli(["train", "--preset", preset, "--workdir", workdir,
              "--iters", str(iters), "--set", f"mesh.data={n}", *extra])
    finally:
        loop.train = train
    carry = captured["carry"]
    kernel = carry.train_state.params["stem_conv"]["kernel"]
    require(len(kernel.sharding.device_set) == n,
            f"params live on {len(kernel.sharding.device_set)} devices")
    rows = [r for r in _metrics(workdir) if r["kind"] == "iter"]
    require(len(rows) == iters and rows[-1]["updated"] == 1.0, rows)
    identical = _replicas_identical(carry.train_state.params)
    print(f"  params bit-identical on all {n} devices: {identical}",
          flush=True)
    require(identical, "replicas differ")
    worst = _learner_step_compare(get_preset(preset), n)
    return {"losses": [r["loss"] for r in rows], "replicas_identical": True,
            "learner_step_max_diff": worst}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU data-parallel path")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    clock = CompileClock()
    info = run_phase(clock, "device", phase_device)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            require(info["count"] >= 4, f"--four-cards needs 4 GPUs: {info}")
            run_phase(clock, "four_cards", phase_four_cards, "host_15x15",
                      os.path.join(tmp, "four"))
        else:
            run_phase(clock, "parity", phase_parity,
                      [("15x15_lowsim", 2048), ("19x19_10b", 4096)])
            run_phase(clock, "search", phase_search)
            run_phase(clock, "train", phase_train, "chip_15x15",
                      os.path.join(tmp, "train"))
            run_phase(clock, "bench_eval", phase_bench_eval, "renju_19x19",
                      2, 2, 200)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
