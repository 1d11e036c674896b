"""CLI surface tests: override parsing and the play-mode plumbing.

The heavyweight subcommands (train/bench) are covered by the integration
tests; here we pin the config-override grammar and the human-play console
loop (SURVEY.md §3.4) with scripted stdin.
"""

import builtins
import io

import pytest

from alphafive_tpu import cli
from alphafive_tpu.config import get_preset


def test_apply_overrides_types():
    cfg = get_preset("tiny_test")
    cfg = cli._apply_overrides(cfg, [
        "mcts.num_simulations=8",
        "net.channels=8",
        "train.learning_rate=0.5",
        "env.rules=renju_lite",
    ])
    assert cfg.mcts.num_simulations == 8
    assert cfg.net.channels == 8
    assert cfg.train.learning_rate == 0.5
    assert cfg.env.rules == "renju_lite"


def test_apply_overrides_rejects_garbage():
    cfg = get_preset("tiny_test")
    with pytest.raises(AssertionError):
        cli._apply_overrides(cfg, ["mcts.num_simulations"])
    with pytest.raises(AttributeError):
        cli._apply_overrides(cfg, ["mcts.nope=1"])
    # a typo'd value for an Optional numeric field must raise loudly, not
    # store the raw string (round-2 advisor finding)
    with pytest.raises(ValueError, match="not numeric"):
        cli._apply_overrides(cfg, ["mcts.branch_cap=12x"])
    # none/null still clears Optional fields
    assert cli._apply_overrides(
        cfg, ["mcts.branch_cap=none"]).mcts.branch_cap is None
    # ...even Optional fields whose current value is set (declared-type
    # check, not value check)
    import dataclasses
    cfg_set = dataclasses.replace(
        cfg, mcts=dataclasses.replace(cfg.mcts, branch_cap=32))
    assert cli._apply_overrides(
        cfg_set, ["mcts.branch_cap=null"]).mcts.branch_cap is None
    # but a REQUIRED field must refuse none/null loudly instead of
    # planting a None that detonates deep in search setup (round-3
    # advisor finding)
    with pytest.raises(ValueError, match="Optional"):
        cli._apply_overrides(cfg, ["mcts.num_simulations=none"])


def test_play_pure_opponent_scripted(monkeypatch, capsys):
    """Console play vs the net-free rollout MCTS, a few scripted moves.

    Feeding EOF mid-game exercises the clean-exit path; a full game would
    take minutes on CPU.
    """
    moves = iter(["2 2", "1 1"])

    def fake_input(prompt=""):
        try:
            return next(moves)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)
    rc = cli.main([
        "play", "--preset", "tiny_test", "--platform", "cpu",
        "--opponent", "pure", "--sims", "8",
    ])
    out = capsys.readouterr().out
    assert rc == 0 or rc is None
    assert "AI plays" in out or "bye" in out


def test_all_presets_construct_and_json_roundtrip():
    """Every named preset (the BASELINE configs + training recipes +
    lowsim_15x15) builds, serializes to JSON (the form embedded in every
    checkpoint), and round-trips losslessly; gumbel presets satisfy the
    search's branch_cap=None requirement (mcts/gumbel.py)."""
    from alphafive_tpu.config import PRESETS, RunConfig

    for name, make in PRESETS.items():
        cfg = make()
        assert cfg.name == name
        back = RunConfig.from_json(cfg.to_json())
        assert back == cfg, name
        if cfg.mcts.root_selection == "gumbel":
            assert cfg.mcts.branch_cap is None, name


def test_load_model_accepts_export_dir(tmp_path):
    """--workdir pointing at a params-only export dir (export_model)
    loads the model instead of warning and falling back to a fresh net."""
    import dataclasses

    import jax
    import numpy as np

    from alphafive_tpu import cli
    from alphafive_tpu.config import get_preset
    from alphafive_tpu.train import checkpoint as ckpt, learner

    cfg = get_preset("tiny_test")
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, data=1))
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train,
                                  jax.random.key(9))
    d = str(tmp_path / "export")
    ckpt.export_model(d, ts.params, ts.batch_stats, cfg)
    params, batch_stats, net_cfg = cli._load_model(cfg, d)
    assert net_cfg == cfg.net
    np.testing.assert_array_equal(
        np.asarray(params["stem_conv"]["kernel"]),
        np.asarray(ts.params["stem_conv"]["kernel"]))


def test_hbm_footprint_guard():
    """The multihost_15x15 preset collapsed onto one small device must be
    refused, while every single-device config must pass — including the
    per-device SHARD of the multi-host preset that the guard's message
    recommends. The budget is explicit: a 16 GB card's allocator limit at
    JAX's default 75% reservation."""
    import dataclasses
    from alphafive_tpu.config import PRESETS
    from alphafive_tpu.utils.memory import budget_error

    budget = 12_000_000_000
    pod = get_preset("multihost_15x15")
    assert budget_error(pod, 1, budget) is not None
    assert "per-device shard" in budget_error(pod, 1, budget)
    assert budget_error(pod, 8, budget) is None  # intended layout fits
    # the recommended single-device shard passes
    shard = dataclasses.replace(
        pod, mesh=dataclasses.replace(pod.mesh, data=1),
        train=dataclasses.replace(pod.train, num_envs=1024),
        replay=dataclasses.replace(pod.replay, batch_size=512))
    assert budget_error(shard, 1, budget) is None
    for name in ("chip_15x15", "host_15x15", "renju_19x19",
                 "lowsim_15x15", "train_15x15", "train_19x19"):
        assert budget_error(PRESETS[name](), 1, budget) is None, name


def test_pretrained_dir_prefers_strength_ranked_variant():
    """The per-board bundled-model resolution prefers a strength-ranked
    variant dir when one ships: 15×15 must resolve to the
    `pretrained/15x15_lowsim` bundle (beats the classic bundle at every
    neutral budget — its README), while boards without a variant resolve
    to their plain dir and unshipped boards to None."""
    import dataclasses
    import os

    from alphafive_tpu import cli
    from alphafive_tpu.config import get_preset

    cfg15 = get_preset("train_15x15")
    d = cli._pretrained_dir(cfg15)
    assert d is not None and os.path.basename(d) == "15x15_lowsim"

    cfg19 = get_preset("train_19x19")
    d19 = cli._pretrained_dir(cfg19)
    assert d19 is not None and os.path.basename(d19) == "19x19_10b"

    cfg9 = get_preset("train_9x9")
    d9 = cli._pretrained_dir(cfg9)
    assert d9 is not None and os.path.basename(d9) == "9x9"

    cfg7 = dataclasses.replace(
        cfg9, env=dataclasses.replace(cfg9.env, board_size=7))
    assert cli._pretrained_dir(cfg7) is None


def test_config_from_json_drops_removed_fields():
    """Configs live inside every checkpoint/export, so deserialization
    must tolerate fields that later rounds REMOVED from the dataclasses
    (e.g. train.eval_rollouts): loading an old artifact must not raise."""
    import json

    from alphafive_tpu.config import RunConfig, get_preset

    cfg = get_preset("tiny_test")
    d = json.loads(cfg.to_json())
    d["train"]["eval_rollouts"] = 8        # removed round 5
    d["mcts"]["some_future_or_past_knob"] = 1
    back = RunConfig.from_json(json.dumps(d))
    assert back == cfg


class _FakeDevice:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats

    def __str__(self):
        return "fake:0"


def test_memory_guard_reads_the_device_limit():
    """The budget is the device allocator's own bytes_limit (here an
    80 GB card at JAX's default 75% reservation), and the verdict follows
    the estimate against it."""
    from alphafive_tpu.utils.memory import (budget_error, device_budget,
                                            estimate_device_bytes)

    limit = 60_000_000_000
    budget = device_budget(_FakeDevice({"bytes_limit": limit,
                                        "bytes_in_use": 0}))
    assert budget == limit
    assert budget_error(get_preset("chip_15x15"), 1, budget) is None
    big = get_preset("multihost_15x15")
    assert (budget_error(big, 1, budget) is None) == (
        estimate_device_bytes(big, 1) <= limit)


def test_memory_guard_refuses_a_device_without_a_limit():
    from alphafive_tpu.utils.memory import device_budget

    for stats in (None, {}, {"bytes_in_use": 5}):
        with pytest.raises(SystemExit, match="reports no memory limit"):
            device_budget(_FakeDevice(stats))


def _child_env(**extra):
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _run_child(code, env, timeout=300):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_compile_cache_defaults_to_the_checkout():
    import os
    import alphafive_tpu
    out = _run_child("import alphafive_tpu, jax; "
                     "print(jax.config.jax_compilation_cache_dir)",
                     _child_env())
    assert out.returncode == 0, out.stderr
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert out.stdout.strip() == os.path.join(repo, ".jax_cache")
    assert alphafive_tpu.CACHE_DIR == os.path.join(repo, ".jax_cache")


def test_compile_cache_follows_the_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the package sets no other
    directory, and compiled programs land there."""
    cache = tmp_path / "cache"
    out = _run_child(
        "import alphafive_tpu, jax, jax.numpy as jnp; "
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready();"
        "print(jax.config.jax_compilation_cache_dir)",
        _child_env(JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cache)
    assert any(cache.iterdir())


def test_cli_train_runs_without_optional_packages(tmp_path):
    """The main path imports none of flax, orbax, msgpack or tensorboardX:
    `cli train` runs two iterations and checkpoints with an import hook
    that refuses them."""
    code = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'orbax', 'msgpack',"
        " 'tensorboardX'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['cli', 'train', '--preset', 'tiny_test', '--iters',"
        " '2', '--platform', 'cpu', '--workdir', %r]\n"
        "try:\n"
        "    runpy.run_module('alphafive_tpu.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert not any(m.split('.')[0] in ('flax', 'orbax', 'msgpack',"
        " 'tensorboardX') for m in sys.modules)\n" % str(tmp_path))
    out = _run_child(code, _child_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "ckpt" / "2" / "meta.json").exists()
