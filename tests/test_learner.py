"""Learner-specific units: KL-adaptive lr, loss anatomy, optimizer wiring.

The reference adapts an lr multiplier from KL(π_old‖π_new) after each
update phase and early-stops runaway updates (SURVEY.md §3.1
`policy_update`); these tests pin our mirror of that behavior.
"""

import jax
import jax.numpy as jnp
import numpy as np

from alphafive_tpu.config import get_preset
from alphafive_tpu.env import vector
from alphafive_tpu.train import learner


def _state(cfg):
    return learner.init_train_state(cfg.env, cfg.net, cfg.train,
                                    jax.random.key(0))


def test_adapt_lr_scale_directions():
    cfg = get_preset("tiny_test")
    ts = _state(cfg)
    target = cfg.train.kl_target
    up = learner.adapt_lr_scale(ts, jnp.float32(target / 4), target)
    down = learner.adapt_lr_scale(ts, jnp.float32(target * 4), target)
    mid = learner.adapt_lr_scale(ts, jnp.float32(target), target)
    assert float(up.lr_scale) > 1.0
    assert float(down.lr_scale) < 1.0
    assert float(mid.lr_scale) == 1.0


def test_adapt_lr_scale_clamped():
    cfg = get_preset("tiny_test")
    ts = _state(cfg)
    for _ in range(20):
        ts = learner.adapt_lr_scale(ts, jnp.float32(1e9),
                                    cfg.train.kl_target)
    assert float(ts.lr_scale) >= 0.1 - 1e-6
    ts2 = _state(cfg)
    for _ in range(20):
        ts2 = learner.adapt_lr_scale(ts2, jnp.float32(0.0),
                                     cfg.train.kl_target)
    assert float(ts2.lr_scale) <= 10.0 + 1e-6


def test_loss_terms_zero_masked_value():
    """Positions with z_valid=0 contribute nothing to the value loss."""
    cfg = get_preset("tiny_test")
    ts = _state(cfg)
    b = 16
    s = cfg.env.board_size
    feats = jnp.zeros((b, s, s, 4), jnp.float32)
    pi = jnp.ones((b, cfg.env.num_actions)) / cfg.env.num_actions
    z = jnp.ones((b,))
    zv_none = jnp.zeros((b,))
    _, (_, aux) = learner.loss_fn(ts.params, ts.batch_stats, cfg.net,
                                  (feats, pi, z, zv_none), cfg.train)
    assert float(aux["value_loss"]) == 0.0
    _, (_, aux2) = learner.loss_fn(ts.params, ts.batch_stats, cfg.net,
                                   (feats, pi, z, jnp.ones((b,))),
                                   cfg.train)
    assert float(aux2["value_loss"]) > 0.0


def test_sgd_option_steps():
    import dataclasses
    cfg = get_preset("tiny_test")
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, optimizer="sgd"))
    ts = _state(cfg)
    b = 8
    s = cfg.env.board_size
    batch = (jnp.zeros((b, s, s, 4)),
             jnp.ones((b, cfg.env.num_actions)) / cfg.env.num_actions,
             jnp.zeros((b,)), jnp.ones((b,)))
    ts2, aux = jax.jit(
        lambda t: learner.train_step(cfg.net, cfg.train, t, batch)
    )(ts)
    assert int(ts2.step) == 1
    assert np.isfinite(float(aux["loss"]))


def test_head_collapse_mechanism_adam_l2_vs_adamw():
    """In-vitro reproduction of the round-3 19x19 head collapse
    (train/learner.py docstring; docs/TRAINING.md forensics).

    Setup: a linear policy head whose TARGETS are input-independent, so the
    bias-only point is the data optimum and the data gradient vanishes as
    the bias converges. From there:

      * adam + L2-in-the-loss (the old/reference recipe): Adam's second
        moment becomes the L2 gradient itself, the normalized update is
        ~lr per step REGARDLESS of l2_coef, and kernels hit exactly zero
        in ~|w|/lr steps. Two runs with l2_coef 10x apart must collapse at
        nearly the SAME step — the smoking-gun rate-independence.
      * the shipped AdamW path (decoupled decay, make_optimizer): the pull
        is lr*l2_coef*w per step — after the same horizon the kernel keeps
        essentially all its mass.
    """
    import dataclasses

    import optax

    d_in, n_act, batch = 8, 5, 64
    lr, n_steps = 1e-3, 400
    key = jax.random.key(7)
    x = jax.random.normal(key, (batch, d_in))
    pi = jnp.ones((batch, n_act)) / n_act  # constant targets: bias-only opt
    w0 = jnp.full((d_in, n_act), 0.1)

    def data_loss(params):
        logp = jax.nn.log_softmax(x @ params["kernel"] + params["bias"], -1)
        return -jnp.mean(jnp.sum(pi * logp, -1))

    def run(opt, l2_in_loss_coef):
        loss = (lambda p: data_loss(p)
                + l2_in_loss_coef * jnp.sum(p["kernel"] ** 2))
        params = {"kernel": w0, "bias": jnp.zeros((n_act,))}
        state = opt.init(params)

        def step(carry, _):
            params, state = carry
            g = jax.grad(loss)(params)
            updates, state = opt.update(g, state, params)
            params = optax.apply_updates(params, updates)
            return (params, state), jnp.max(jnp.abs(params["kernel"]))

        (params, _), kmax = jax.lax.scan(step, (params, state),
                                         None, length=n_steps)
        return np.asarray(kmax)

    old_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    k_old_a = run(old_opt, l2_in_loss_coef=1e-4)
    k_old_b = run(old_opt, l2_in_loss_coef=1e-3)

    # old recipe: kernels at exact (float) zero well inside the horizon...
    assert k_old_a[-1] < 1e-6, k_old_a[-1]
    assert k_old_b[-1] < 1e-6, k_old_b[-1]
    # ...and the collapse step is l2_coef-INDEPENDENT (within 25% for a
    # 10x coefficient change): the rate is set by lr, not by l2_coef
    first_dead = lambda k: int(np.argmax(k < 1e-3))
    da, db = first_dead(k_old_a), first_dead(k_old_b)
    assert 0 < db <= da and (da - db) / da < 0.25, (da, db)

    # shipped path: same horizon, decoupled decay, no L2 in the loss
    cfg = dataclasses.replace(
        get_preset("tiny_test").train,
        learning_rate=lr, l2_coef=1e-4, lr_warmup_steps=1)
    assert cfg.optimizer == "adam"
    k_new = run(learner.make_optimizer(cfg), l2_in_loss_coef=0.0)
    # decay removes at most lr*l2_coef per step; data gradient is what it
    # is — the kernel must retain essentially all of its mass
    assert k_new[-1] > 0.9 * float(jnp.max(jnp.abs(w0))), k_new[-1]


def test_adam_loss_excludes_l2_term():
    """Under adam the L2 term must stay OUT of the loss (it lives in the
    optimizer as decoupled decay); re-adding it recreates the collapse
    mechanism pinned above. l2_loss stays logged as a diagnostic."""
    cfg = get_preset("tiny_test")
    ts = _state(cfg)
    b, s = 4, cfg.env.board_size
    batch = (jnp.zeros((b, s, s, 4)),
             jnp.ones((b, cfg.env.num_actions)) / cfg.env.num_actions,
             jnp.zeros((b,)), jnp.ones((b,)))
    loss, (_, aux) = learner.loss_fn(ts.params, ts.batch_stats, cfg.net,
                                     batch, cfg.train)
    expect = (float(aux["policy_loss"])
              + cfg.train.value_loss_weight * float(aux["value_loss"]))
    assert float(loss) == np.float32(expect)
    assert float(aux["l2_loss"]) > 0.0  # still logged
