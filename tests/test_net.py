"""The plain-JAX net against golden numbers recorded with the original
implementation (tests/golden_net.npz): eval forwards of every bundled
model, a train-mode forward with its BatchNorm statistics update, and one
learner step. Also the params-only model file format.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafive_tpu.config import get_preset
from alphafive_tpu.env import vector
from alphafive_tpu.models.resnet import apply_eval, apply_train
from alphafive_tpu.train import checkpoint as ckpt, learner
from alphafive_tpu.utils import pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = pytree.unflatten(dict(np.load(os.path.join(REPO, "tests",
                                                    "golden_net.npz"))))
BUNDLES = sorted(GOLDEN["bundle"])


def test_fixture_covers_every_bundle():
    shipped = sorted(d for d in os.listdir(os.path.join(REPO, "pretrained"))
                     if os.path.exists(os.path.join(REPO, "pretrained", d,
                                                    ckpt.MODEL_FILE)))
    assert BUNDLES == shipped


@pytest.mark.parametrize("name", BUNDLES)
def test_bundle_forward_matches_golden(name):
    """float32 forward: same numbers as the original implementation (the
    suite runs at highest matmul precision); bf16 production forward:
    the same up to bf16 rounding."""
    g = GOLDEN["bundle"][name]
    params, bs, cfg = ckpt.load_model(os.path.join(REPO, "pretrained", name))
    feats = vector.features(cfg.env, jnp.asarray(g["board"]),
                            jnp.asarray(g["to_play"]), jnp.asarray(g["last"]))
    f32 = dataclasses.replace(cfg.net, compute_dtype="float32")
    lg, v = jax.jit(lambda p, b, x: apply_eval(f32, p, b, x))(params, bs,
                                                              feats)
    np.testing.assert_allclose(np.asarray(lg), g["logits_float32"],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(v), g["value_float32"],
                               atol=1e-5, rtol=1e-4)
    assert cfg.net.compute_dtype == "bfloat16"
    lg, v = jax.jit(lambda p, b, x: apply_eval(cfg.net, p, b, x))(
        params, bs, feats)
    np.testing.assert_allclose(np.asarray(lg), g["logits_bfloat16"],
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(v), g["value_bfloat16"],
                               atol=2e-2)


def _tiny_state():
    t = GOLDEN["train"]
    cfg = get_preset("tiny_test")
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train,
                                  jax.random.key(0))
    as_jnp = lambda tree: jax.tree.map(jnp.asarray, tree)
    return cfg, ts.replace(params=as_jnp(t["params"]),
                           batch_stats=as_jnp(t["batch_stats"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_stats_match_golden(dtype):
    """Train mode normalizes with batch statistics computed in float32
    (whatever the compute dtype) and moves the running stats by
    momentum 0.99."""
    cfg, ts = _tiny_state()
    g = GOLDEN["train"][dtype]
    net = dataclasses.replace(cfg.net, compute_dtype=dtype)
    (lg, v), new_bs = jax.jit(lambda p, b, x: apply_train(net, p, b, x))(
        ts.params, ts.batch_stats, jnp.asarray(GOLDEN["train"]["features"]))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(lg), g["logits"], atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(np.asarray(v), g["value"], atol=tol)
    assert jax.tree.structure(new_bs) == jax.tree.structure(
        g["new_batch_stats"])
    for got, want in zip(jax.tree.leaves(new_bs),
                         jax.tree.leaves(g["new_batch_stats"])):
        assert got.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5,
                                   rtol=1e-5)


def test_learner_step_matches_golden():
    cfg, ts = _tiny_state()
    t = GOLDEN["train"]
    batch = tuple(jnp.asarray(t[k]) for k in
                  ("features", "pi", "z", "z_valid", "pi_valid"))
    new_ts, aux = jax.jit(lambda s, b: learner.train_step(
        cfg.net, cfg.train, s, b))(ts, batch)
    for k, want in GOLDEN["step"]["aux"].items():
        np.testing.assert_allclose(float(aux[k]), want, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for tree in ("params", "batch_stats"):
        for got, want in zip(jax.tree.leaves(getattr(new_ts, tree)),
                             jax.tree.leaves(GOLDEN["step"][tree])):
            np.testing.assert_allclose(np.asarray(got), want, atol=1e-6,
                                       rtol=1e-5)


def test_model_file_is_flat_npz_and_round_trips(tmp_path):
    """export_model writes one .npz of float32 arrays keyed
    "params/<module>/.../<leaf>" and "batch_stats/..."; load_model reads
    back the same tree."""
    params, bs, cfg = ckpt.load_model(os.path.join(REPO, "pretrained",
                                                   "9x9"))
    d = str(tmp_path / "export")
    ckpt.export_model(d, params, bs, cfg, extra={"iteration": 1})
    with np.load(os.path.join(d, ckpt.MODEL_FILE)) as f:
        keys = set(f.files)
        assert "params/block3/conv2/kernel" in keys
        assert "batch_stats/value_bn/var" in keys
        assert all(f[k].dtype == np.float32 for k in keys)
    params2, bs2, cfg2 = ckpt.load_model(d)
    assert cfg2 == cfg
    assert jax.tree.structure(params2) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves((params, bs)),
                    jax.tree.leaves((params2, bs2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
