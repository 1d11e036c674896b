"""Model surgery (models/surgery.py): function preservation + transfer.

The widen/deepen transforms must be EXACT function preservers at noise=0
(Net2Net's defining property) — checked against the source net's outputs
on random inputs in both eval and train mode. resize_board is checked
for shape validity and for keeping the policy FC's learned diagonal
(local position→action) structure rather than re-randomizing it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafive_tpu.config import EnvConfig, NetConfig
from alphafive_tpu.models import surgery
from alphafive_tpu.models.resnet import (apply_eval, apply_train,
                                         init_variables)

ENV = EnvConfig(board_size=7)
NET = NetConfig(blocks=2, channels=8, value_hidden=16,
                compute_dtype="float32")


def _trained_ish(key):
    """Init + a few noisy train steps so BN stats/params are non-trivial."""
    variables = init_variables(ENV, NET, key)
    params, bs = variables["params"], variables["batch_stats"]
    for i in range(2):
        x = jax.random.normal(jax.random.fold_in(key, i), (2, 7, 7, 4))
        _, bs = apply_train(NET, params, bs, x)
    return {"params": params, "batch_stats": bs}


@pytest.fixture(scope="module")
def src():
    return _trained_ish(jax.random.key(7))


def _outputs(net, variables, x):
    return apply_eval(net, variables["params"],
                      variables["batch_stats"], x)


def test_widen_preserves_function(src):
    wide = surgery.widen(src, 12, jax.random.key(1), noise=0.0)
    x = jax.random.normal(jax.random.key(2), (5, 7, 7, 4))
    p0, v0 = _outputs(NET, src, x)
    p1, v1 = _outputs(NetConfig(blocks=2, channels=12, value_hidden=16,
                                compute_dtype="float32"), wide, x)
    np.testing.assert_allclose(p1, p0, atol=2e-4)
    np.testing.assert_allclose(v1, v0, atol=2e-4)


def test_widen_noise_breaks_symmetry(src):
    wide = surgery.widen(src, 12, jax.random.key(1), noise=1e-2)
    k = wide["params"]["block0"]["conv1"]["kernel"]
    # duplicated filters must not be bit-identical to their sources
    g_extra = k[..., 8:]
    assert not np.allclose(np.asarray(g_extra), 0.0)
    diffs = [np.abs(np.asarray(k[..., j]) - np.asarray(k[..., i])).max()
             for j in range(8, 12) for i in range(8)]
    assert min(diffs) > 0.0


def test_deepen_preserves_function_exactly(src):
    deep = surgery.deepen(src, 4, jax.random.key(3))
    x = jax.random.normal(jax.random.key(4), (5, 7, 7, 4))
    p0, v0 = _outputs(NET, src, x)
    p1, v1 = _outputs(NetConfig(blocks=4, channels=8, value_hidden=16,
                                compute_dtype="float32"), deep, x)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v0))


def test_deepen_identity_in_train_mode(src):
    """BatchNorm over the zero conv2 output must stay zero in train mode
    too (batch stats of an all-zero activation), so the first training
    steps after surgery do not perturb the transferred function."""
    deep = surgery.deepen(src, 4, jax.random.key(3))
    net4 = NetConfig(blocks=4, channels=8, value_hidden=16,
                     compute_dtype="float32")
    x = jax.random.normal(jax.random.key(4), (5, 7, 7, 4))
    (p1, v1), _ = apply_train(net4, deep["params"],
                              deep["batch_stats"], x)
    (p0, v0), _ = apply_train(NET, src["params"],
                              src["batch_stats"], x)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v0), atol=1e-5)


def test_resize_board_shapes_and_structure(src):
    big = surgery.resize_board(src, 7, 9)
    assert big["params"]["policy_fc"]["kernel"].shape == (2 * 81, 81)
    assert big["params"]["policy_fc"]["bias"].shape == (81,)
    assert big["params"]["value_fc1"]["kernel"].shape == (81, 16)
    assert np.isfinite(np.asarray(
        big["params"]["policy_fc"]["kernel"])).all()
    # (a forward at the new board size runs in the transfer test below)
    # the resized policy FC keeps the source's diagonal dominance: the
    # mean |weight| from a position's own features to its own action
    # exceeds the mean off-diagonal |weight| iff the source had that
    # structure — enforce relative preservation
    def diag_ratio(kernel, s):
        w = np.abs(np.asarray(kernel).reshape(s, s, 2, s, s))
        idx = np.arange(s)
        diag = w[idx[:, None], idx[None, :], :, idx[:, None],
                 idx[None, :]].mean()
        return diag / w.mean()
    r_old = diag_ratio(src["params"]["policy_fc"]["kernel"], 7)
    r_new = diag_ratio(big["params"]["policy_fc"]["kernel"], 9)
    # bilinear resize smears but must not destroy the structure
    assert r_new > 0.5 * r_old


def test_transfer_end_to_end_matches_dst_tree(src):
    dst_env = EnvConfig(board_size=9, rules="renju")
    dst_net = NetConfig(blocks=4, channels=12, value_hidden=16,
                        compute_dtype="float32")
    out = surgery.transfer(src, ENV, NET, dst_env, dst_net,
                           jax.random.key(6))
    x = jax.random.normal(jax.random.key(7), (2, 9, 9, 4))
    p, v = _outputs(dst_net, out, x)
    assert p.shape == (2, 81) and np.isfinite(np.asarray(p)).all()
    assert np.isfinite(np.asarray(v)).all()


def test_transfer_rejects_narrowing(src):
    with pytest.raises(AssertionError):
        surgery.transfer(src, ENV, NET, ENV,
                         NetConfig(blocks=2, channels=4, value_hidden=16),
                         jax.random.key(0))
