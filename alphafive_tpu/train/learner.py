"""Learner: loss, optimizer, one SGD step.

Loss mirrors the reference semantics (SURVEY.md §3.3): value MSE + policy
cross-entropy against the MCTS visit distribution + L2 on kernels, optimized
with Adam. Differences, by design:

  * The value term is masked by `z_valid` (positions from unfinished games
    have no value target — see train/actor.py) and renormalized; the policy
    term is likewise masked by `pi_valid` (cheap playout-cap-randomized
    searches are value-only positions, actor.py).
  * Kernel regularization is DECOUPLED weight decay under Adam (AdamW),
    not the reference's L2-in-the-loss. Measured reason (round 3, the
    19×19 Renju run): when a net degenerates toward a bias-only policy the
    data gradient vanishes, Adam's second moment becomes dominated by the
    L2 gradient itself, and the normalized update drives kernels to zero
    at a rate of ~lr per step REGARDLESS of l2_coef — the un-BN'd head
    kernels (policy_fc, value_*) collapsed to exact zero within ~50
    iterations and the run was permanently stuck at value_loss≈1.0.
    Decoupled decay shrinks weights by lr·l2_coef·w per step — a bounded,
    coefficient-proportional pull that cannot out-scale a live data
    gradient. The `sgd` option keeps the explicit L2 loss term (there the
    reference semantics are safe: no gradient normalization).
  * Gradients are averaged over the `data` mesh axis with `psum` when run
    under shard_map (parallel/mesh.py) — the data-parallel replacement for
    the reference's single-GPU update (SURVEY.md §2 parallelism table).

Also computes KL(π_mcts ‖ p_net) — the quantity the reference uses for its
adaptive-lr early stopping — as a logged metric.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from alphafive_tpu.config import EnvConfig, NetConfig, TrainConfig
from alphafive_tpu.models.resnet import apply_train, init_variables
from alphafive_tpu.utils import pytree


@pytree.dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray      # int32[]
    lr_scale: jnp.ndarray  # f32[] — KL-adaptive multiplier (SURVEY.md §3.1:
    # the reference adapts an lr multiplier from KL(π_old‖π_new) after each
    # update phase; we mirror that with ×1.5 / ÷1.5 clamped to [0.1, 10])


def _kernel_mask(params):
    """True for every conv/dense kernel leaf (the regularized set)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: any(getattr(k, "key", None) == "kernel"
                            for k in path), params)


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.linear_schedule(
        init_value=0.0, end_value=cfg.learning_rate,
        transition_steps=max(cfg.lr_warmup_steps, 1))
    if cfg.optimizer == "sgd":
        # reference semantics: L2 lives in the loss (see loss_fn); plain
        # momentum SGD sees it as a gradient term.
        opt = optax.sgd(schedule, momentum=cfg.momentum)
    else:
        # AdamW: decay applied to the post-Adam update, masked to kernels
        # (see module docstring for the measured L2+Adam collapse this
        # replaces).
        opt = optax.chain(
            optax.scale_by_adam(),
            optax.add_decayed_weights(cfg.l2_coef, mask=_kernel_mask),
            optax.scale_by_learning_rate(schedule))
    return optax.chain(optax.clip_by_global_norm(1.0), opt)


def init_train_state(env_cfg: EnvConfig, net_cfg: NetConfig,
                     train_cfg: TrainConfig, key: jax.Array) -> TrainState:
    variables = init_variables(env_cfg, net_cfg, key)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    opt = make_optimizer(train_cfg)
    return TrainState(params=params, batch_stats=batch_stats,
                      opt_state=opt.init(params),
                      step=jnp.zeros((), jnp.int32),
                      lr_scale=jnp.ones((), jnp.float32))


def _l2_of_kernels(params) -> jnp.ndarray:
    acc = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if any(getattr(k, "key", None) == "kernel" for k in path):
            acc = acc + jnp.sum(jnp.square(leaf.astype(jnp.float32)))
    return acc


def loss_fn(params, batch_stats, net_cfg: NetConfig, batch,
            train_cfg: TrainConfig):
    feats, pi, z, z_valid, pi_valid = (batch if len(batch) == 5
                                       else (*batch, None))
    (logits, value), new_bs = apply_train(net_cfg, params, batch_stats, feats)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = jnp.sum(pi * logp, axis=-1)
    if pi_valid is None:
        policy_loss = -jnp.mean(ce)
    else:
        policy_loss = (-jnp.sum(ce * pi_valid)
                       / jnp.maximum(jnp.sum(pi_valid), 1.0))
    value_loss = (jnp.sum(jnp.square(value - z) * z_valid)
                  / jnp.maximum(jnp.sum(z_valid), 1.0))
    # l2_loss is always LOGGED (kernel-mass diagnostic — its collapse to 0
    # is the signature of the round-3 head-death pathology) but only added
    # to the loss under sgd; adam regularizes via decoupled decay in
    # make_optimizer.
    l2_loss = train_cfg.l2_coef * _l2_of_kernels(params)
    loss = policy_loss + train_cfg.value_loss_weight * value_loss
    if train_cfg.optimizer == "sgd":
        loss = loss + l2_loss
    # diagnostics (SURVEY.md §5.5): KL(π‖p), value MAE, policy entropy
    kl = jnp.mean(jnp.sum(jnp.where(pi > 0, pi * (jnp.log(
        jnp.maximum(pi, 1e-10)) - logp), 0.0), axis=-1))
    aux = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "l2_loss": l2_loss,
        "kl_pi_p": kl,
        "value_mae": (jnp.sum(jnp.abs(value - z) * z_valid)
                      / jnp.maximum(jnp.sum(z_valid), 1.0)),
        "entropy_pi": -jnp.mean(jnp.sum(
            jnp.where(pi > 0, pi * jnp.log(jnp.maximum(pi, 1e-10)), 0.0),
            axis=-1)),
    }
    return loss, (new_bs, aux)


def train_step(net_cfg: NetConfig, train_cfg: TrainConfig,
               ts: TrainState, batch,
               axis_name: Optional[str] = None
               ) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
    """One SGD step. Under shard_map, pass axis_name to pmean grads/stats."""
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    (_, (new_bs, aux)), grads = grad_fn(ts.params, ts.batch_stats, net_cfg,
                                        batch, train_cfg)
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        new_bs = jax.lax.pmean(new_bs, axis_name)
        aux = jax.lax.pmean(aux, axis_name)
    opt = make_optimizer(train_cfg)
    updates, new_opt = opt.update(grads, ts.opt_state, ts.params)
    updates = jax.tree.map(lambda u: u * ts.lr_scale, updates)
    params = optax.apply_updates(ts.params, updates)
    aux["grad_norm"] = optax.global_norm(grads)
    aux["lr_scale"] = ts.lr_scale
    return TrainState(params=params, batch_stats=new_bs, opt_state=new_opt,
                      step=ts.step + 1, lr_scale=ts.lr_scale), aux


def adapt_lr_scale(ts: TrainState, kl: jnp.ndarray, kl_target: float,
                   scale_max: float = 10.0) -> TrainState:
    """Reference-family adaptive lr: shrink when the update moved the policy
    too far (KL > 2·target), grow when it barely moved (KL < target/2).

    `scale_max` caps the multiplier. The controller's blind spot: a
    DEGENERATE policy (bias-only logits) also produces tiny per-update KL,
    which the controller reads as "lr too small" and amplifies — at the
    hardcoded 10× cap this fed the 19×19 head-collapse limit cycle (see
    module docstring). Presets for hard configs set a lower cap."""
    up = kl < kl_target / 2
    down = kl > kl_target * 2
    scale = ts.lr_scale * jnp.where(down, 1.0 / 1.5,
                                    jnp.where(up, 1.5, 1.0))
    return ts.replace(lr_scale=jnp.clip(scale, 0.1, scale_max))
