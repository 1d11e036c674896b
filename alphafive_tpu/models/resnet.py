"""Residual policy-value network, in plain ``jax.numpy`` / ``lax``.

The reference's net is a TF-graph conv stem → N residual blocks →
policy head (1×1 conv → FC → log-softmax over board²) + value head
(1×1 conv → FC → tanh), loss = value MSE + policy CE + L2
(SURVEY.md §1 L3, §2 "Policy-value net", §3.3). Choices here:

  * NHWC activations, HWIO kernels, compute in ``NetConfig.compute_dtype``
    (bfloat16 by default) with float32 params; float32 heads.
  * BatchNorm with running stats carried functionally (``batch_stats``):
    batch statistics in float32 whatever the compute dtype, momentum 0.99,
    eps 1e-5. Eval mode (running stats) inside MCTS leaf evaluation.

The variable tree is ``{"params": ..., "batch_stats": ...}`` with
``params/{stem_conv, block{i}/conv1, ...}/kernel``, ``.../bn*/scale|bias``,
``batch_stats/.../mean|var`` and the dense heads ``policy_fc``,
``value_fc1``, ``value_fc2`` (``kernel`` + ``bias``) — the layout of the
bundled models and of models/surgery.py.

The net returns raw policy *logits*; masking + softmax over legal moves
happens in the search, matching the "masked softmax at the root" semantics.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, NetConfig

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def _dtype(cfg: NetConfig):
    return jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32


def init_variables(env: EnvConfig, net: NetConfig,
                   key: jax.Array) -> Dict[str, Any]:
    """Fresh variables: lecun-normal kernels, zero biases, BN scale 1 /
    bias 0, running mean 0 / var 1 (all float32)."""
    lecun = jax.nn.initializers.lecun_normal()
    keys = iter(jax.random.split(key, 2 * net.blocks + 6))
    c, a, h = net.channels, env.num_actions, net.value_hidden

    def conv(k, cin, cout):
        return {"kernel": lecun(next(keys), (k, k, cin, cout), jnp.float32)}

    def dense(cin, cout):
        return {"kernel": lecun(next(keys), (cin, cout), jnp.float32),
                "bias": jnp.zeros((cout,), jnp.float32)}

    def bn(n):
        return ({"scale": jnp.ones((n,), jnp.float32),
                 "bias": jnp.zeros((n,), jnp.float32)},
                {"mean": jnp.zeros((n,), jnp.float32),
                 "var": jnp.ones((n,), jnp.float32)})

    params: Dict[str, Any] = {"stem_conv": conv(3, 4, c)}
    stats: Dict[str, Any] = {}
    params["stem_bn"], stats["stem_bn"] = bn(c)
    for i in range(net.blocks):
        blk, bst = {"conv1": conv(3, c, c)}, {}
        blk["bn1"], bst["bn1"] = bn(c)
        blk["conv2"] = conv(3, c, c)
        blk["bn2"], bst["bn2"] = bn(c)
        params[f"block{i}"], stats[f"block{i}"] = blk, bst
    params["policy_conv"] = conv(1, c, 2)
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * a, a)
    params["value_conv"] = conv(1, c, 1)
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"] = dense(a, h)
    params["value_fc2"] = dense(h, 1)
    return {"params": params, "batch_stats": stats}


def _conv(x, p, dt):
    return jax.lax.conv_general_dilated(
        x, p["kernel"].astype(dt), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _batchnorm(x, p, s, train: bool, dt):
    """BatchNorm over N, H, W → (output in the compute dtype, updated
    running stats or None). Statistics in float32."""
    new_s = None
    if train:
        xf = x.astype(jnp.float32)
        mean = xf.mean((0, 1, 2))
        # one-pass variance E[x²] - E[x]², clipped at 0 against round-off
        var = jnp.maximum(0.0, jnp.square(xf).mean((0, 1, 2))
                          - jnp.square(mean))
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = s["mean"], s["var"]
    y = (x - mean) * (jax.lax.rsqrt(var + BN_EPS) * p["scale"]) + p["bias"]
    return y.astype(dt), new_s


def _dense(x, p):
    return x @ p["kernel"] + p["bias"]


def apply(net: NetConfig, params, batch_stats, features: jnp.ndarray,
          train: bool = False):
    """[B, S, S, 4] features → ((policy_logits[B, S*S], value[B]),
    new_batch_stats). new_batch_stats is None in eval mode."""
    dt = _dtype(net)
    new_stats: Dict[str, Any] = {}

    def conv_bn(x, p, s, conv_name, bn_name, out):
        y = _conv(x, p[conv_name], dt)
        y, out[bn_name] = _batchnorm(y, p[bn_name], s[bn_name], train, dt)
        return y

    x = features.astype(dt)
    x = jax.nn.relu(conv_bn(x, params, batch_stats, "stem_conv", "stem_bn",
                            new_stats))
    for i in range(net.blocks):
        p, s = params[f"block{i}"], batch_stats[f"block{i}"]
        out = new_stats[f"block{i}"] = {}
        y = jax.nn.relu(conv_bn(x, p, s, "conv1", "bn1", out))
        y = conv_bn(y, p, s, "conv2", "bn2", out)
        x = jax.nn.relu(x + y)

    b = x.shape[0]
    # policy head: 1×1 conv (2 ch) → FC over board → logits
    pol = jax.nn.relu(conv_bn(x, params, batch_stats, "policy_conv",
                              "policy_bn", new_stats))
    logits = _dense(pol.reshape(b, -1).astype(jnp.float32),
                    params["policy_fc"])
    # value head: 1×1 conv (1 ch) → FC(hidden) → FC(1) → tanh
    v = jax.nn.relu(conv_bn(x, params, batch_stats, "value_conv",
                            "value_bn", new_stats))
    v = jax.nn.relu(_dense(v.reshape(b, -1).astype(jnp.float32),
                           params["value_fc1"]))
    v = _dense(v, params["value_fc2"])
    return (logits, jnp.tanh(v)[:, 0]), (new_stats if train else None)


def apply_eval(net: NetConfig, params, batch_stats,
               features: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inference forward (MCTS leaf eval): running BN stats, no mutation."""
    return apply(net, params, batch_stats, features, train=False)[0]


def apply_train(net: NetConfig, params, batch_stats, features: jnp.ndarray):
    """Training forward: returns ((logits, value), new_batch_stats)."""
    return apply(net, params, batch_stats, features, train=True)
