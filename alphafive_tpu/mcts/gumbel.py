"""Gumbel root search with sequential halving (Danihelka et al. 2022,
"Policy Improvement by Planning with Gumbel").

Why it exists here: the cheapest self-play data engine runs at average
budgets of ≤~16 simulations per move — exactly the regime where the
classic AlphaZero root (Dirichlet noise + visit-count targets, the
reference family's scheme, SURVEY.md §2 "MCTS player") degrades: with a
handful of sims the visit distribution is mostly noise and the π target
carries almost no policy improvement. Gumbel search is the published fix:

  * Exploration via Gumbel noise g on the root logits (sampling without
    replacement), not Dirichlet + temperature.
  * The root budget is spent by SEQUENTIAL HALVING over the top-m
    candidates by g + logits: every surviving candidate is visited
    equally, then the half with the worst g + logits + σ(q̂) is dropped.
  * The played action is the final halving winner — guaranteed policy
    improvement in expectation even at tiny budgets.
  * The training target is the IMPROVED POLICY
    π' = softmax(logits + σ(completed Q)), not visit counts.

σ(q) = (c_visit + max_b N(b)) · c_scale · q is the paper's monotone
transform; completed Q fills unvisited actions with the mixed value
estimate v_mix.

Batched design: the halving survivors ARE the leaf-parallel lanes.
Each pass forces every lane to a DISTINCT root child (search._select_one's
`root_action` hook) and descends PUCT below it, so all survivors advance
in one batched env.step + one net forward per pass and — because distinct
root edges lead to disjoint subtrees — no virtual-visit machinery is
needed at all (contrast mcts/search.py's lane-divergence work). Lane
counts shrink with the halving schedule, so late passes are cheaper.

Deviation from the paper, documented: interior (non-root) selection uses
this repo's PUCT descent rather than the paper's deterministic
visit-discrepancy rule — at the ≤2-visits-per-subtree budgets this search
targets, interior selection is exercised barely once per lane and the
shared machinery keeps the implementation oracle-testable against
mcts/reference.py with identical conventions.

The NumPy oracle (reference.run_gumbel_reference) mirrors this module
op-for-op; tests/test_gumbel.py pins visit counts, the chosen action and
π' on frozen evaluators.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.mcts import search
from alphafive_tpu.mcts.search import (Evaluator, _gather_env_lanes,
                                       _select_one, _tree_init,
                                       masked_softmax)


class GumbelResult(NamedTuple):
    visits: jnp.ndarray      # f32[E, A] root visit counts
    root_value: jnp.ndarray  # f32[E] W(root)/N(root)
    priors: jnp.ndarray      # f32[E, A] softmax(logits) (no noise)
    action: jnp.ndarray      # int32[E] halving winner (the move to play)
    pi_target: jnp.ndarray   # f32[E, A] improved policy π'


def build_schedule(budget: int, m: int) -> List[Tuple[int, int]]:
    """Static sequential-halving schedule: [(lanes, passes), ...].

    Each group runs `passes` passes of `lanes` lanes (one visit per
    surviving candidate per pass); groups halve the survivor count.
    The paper splits the budget evenly over log2(m) phases; leftovers are
    spent on the final 2-candidate phase, with a trailing 1-lane group
    for any odd remainder — Σ lanes·passes == budget exactly.
    """
    assert budget >= 1 and m >= 1
    m = min(m, budget)
    if m < 2:
        return [(1, budget)]
    phases = max(1, (m - 1).bit_length())  # ceil(log2(m))
    groups: List[Tuple[int, int]] = []
    left = budget
    k, mk = 0, m
    while mk >= 2 and left >= mk:
        if mk <= 2:            # final phase: spend everything left
            per = left // mk
        else:
            per = max(1, (budget // phases) // mk)
        per = min(per, left // mk)
        if per == 0:
            break
        groups.append((mk, per))
        left -= mk * per
        mk = max(2, mk // 2)
        k += 1
    if left > 0:
        groups.append((1, left))
    assert sum(l * p for l, p in groups) == budget, (groups, budget)
    return groups


def _sigma_q(n0: jnp.ndarray, q: jnp.ndarray, c_visit: float,
             c_scale: float) -> jnp.ndarray:
    """σ(q) = (c_visit + max_b N(b)) · c_scale · q  (paper eq. 8)."""
    max_n = jnp.max(n0, axis=-1, keepdims=True)
    return (jnp.float32(c_visit) + max_n) * jnp.float32(c_scale) * q


def run_gumbel_mcts(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Evaluator,
    state: EnvState,
    key: jax.Array,
    *,
    num_simulations: Optional[int] = None,
    add_noise: bool = True,
    gumbel: Optional[jnp.ndarray] = None,
) -> GumbelResult:
    """Gumbel sequential-halving search on every env's current position.

    `add_noise` maps to the paper's self-play/eval split: True samples
    Gumbel noise (stochastic exploration), False sets g = 0 (deterministic
    — play the argmax of logits + σ(q̂), the eval-time behavior).
    `gumbel` injects a fixed g table (oracle-parity tests).
    """
    sims = int(num_simulations or mcts_cfg.num_simulations)
    if mcts_cfg.branch_cap is not None:
        # production slot-tree layout: the halving lanes force root SLOTS
        # via search_capped._select_lanes' forced_slots hook
        return _run_gumbel_capped(env_cfg, mcts_cfg, evaluate, state, key,
                                  sims=sims, add_noise=add_noise,
                                  gumbel=gumbel)
    e, a = state.board.shape
    schedule = build_schedule(sims, min(int(mcts_cfg.gumbel_m), a))
    m = schedule[0][0]
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (jnp.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else jnp.float32)
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    value_dtype = jnp.int16 if fixed_w else jnp.float32
    w_scale = 64.0 if fixed_w else 1.0
    c_puct = jnp.float32(mcts_cfg.c_puct)
    c_visit = float(mcts_cfg.gumbel_c_visit)
    c_scale = float(mcts_cfg.gumbel_c_scale)

    key, kg, keval = jax.random.split(key, 3)

    tree = _tree_init(env_cfg, e, nn, prior_dtype, value_dtype)
    tree = tree.replace(
        node_board=tree.node_board.at[:, 0].set(state.board),
        node_to_play=tree.node_to_play.at[:, 0].set(state.to_play),
        node_last=tree.node_last.at[:, 0].set(state.last_move),
        node_count=tree.node_count.at[:, 0].set(state.move_count),
        node_done=tree.node_done.at[:, 0].set(state.done),
        node_winner=tree.node_winner.at[:, 0].set(state.winner),
    )
    root_logits, root_v = evaluate(state.board, state.to_play,
                                   state.last_move, keval)
    root_logits = root_logits.astype(jnp.float32)
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)
    tree = tree.replace(p=tree.p.at[:, 0].set(
        jnp.where(root_legal, root_p, -1.0).astype(prior_dtype)))

    if gumbel is not None:
        g = gumbel.astype(jnp.float32)
    elif add_noise:
        g = jax.random.gumbel(kg, (e, a), jnp.float32)
    else:
        g = jnp.zeros((e, a), jnp.float32)
    # scores live on g + logits (+ σ(q̂) once visited); illegal = -inf
    glogits = jnp.where(root_legal, g + root_logits, -jnp.inf)

    # top-m candidates by g + logits; envs with fewer than m legal moves
    # pad with their best candidate (duplicate lanes just revisit the same
    # subtree — the duplicate-expansion dedup below keeps the tree sound)
    _, cand = jax.lax.top_k(glogits, m)                       # [E, m]
    cand = cand.astype(jnp.int32)
    cand_legal = jnp.take_along_axis(root_legal, cand, axis=1)
    cand = jnp.where(cand_legal, cand, cand[:, :1])

    earange = jnp.arange(e)
    d = depth_limit
    zero_vroot = jnp.zeros((e, a), jnp.float32)
    # env-vmapped forced-root descent, then lane-vmapped (tree broadcast)
    select_env = jax.vmap(
        _select_one,
        in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None, 0))
    select_lanes = jax.vmap(
        select_env,
        in_axes=(None, None, None, None, None, None, None, None, None,
                 None, 1),
        out_axes=1)

    def root_stats(tree):
        n0 = tree.n[:, 0, :].astype(jnp.float32)
        w0 = tree.w[:, 0, :].astype(jnp.float32) / w_scale
        q = jnp.where(n0 > 0, w0 / jnp.maximum(n0, 1.0), 0.0)
        return n0, q

    def cand_scores(tree, cand):
        """g + logits + σ(q̂) at the current candidates ([E, lanes])."""
        n0, q = root_stats(tree)
        score_all = glogits + _sigma_q(n0, q, c_visit, c_scale)
        return jnp.take_along_axis(score_all, cand, axis=1)

    def make_pass(lb: int, base0: int):
        """One halving pass: visit all `lb` survivors (lane j forced to
        root child cand[:, j]), expand, one batched forward, backup.
        Mirrors search.run_mcts's pass body minus noise/virtual visits."""

        def pass_body(i, carry):
            tree, cand, key = carry
            key, keval = jax.random.split(key)
            lps, acts, deps, pns, pas = select_lanes(
                tree.n, tree.w, tree.p, tree.child, tree.node_done,
                zero_vroot, c_puct, d, 1.0 / w_scale, jnp.float32(0.0),
                cand)

            is_revisit = acts < 0
            safe_act = jnp.maximum(acts, 0)
            parent_state = _gather_env_lanes(tree, lps)
            flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
            unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
            stepped_f = vector.step(
                env_cfg, jax.tree.map(flat, parent_state), flat(safe_act))
            stepped = jax.tree.map(unflat, stepped_f)

            def sel(a_, b_):
                mk = is_revisit.reshape(is_revisit.shape
                                        + (1,) * (a_.ndim - 2))
                return jnp.where(mk, a_, b_)

            leaf_state = jax.tree.map(sel, parent_state, stepped)

            base = base0 + i * lb
            # duplicate expansions (padded duplicate lanes stopping at the
            # same unexpanded edge) resolve to the first lane's node id —
            # same scheme as search.run_mcts
            edge_key = lps * a + safe_act
            expanding = ~is_revisit
            same = ((edge_key[:, :, None] == edge_key[:, None, :])
                    & expanding[:, :, None] & expanding[:, None, :])
            jj = jnp.arange(lb, dtype=jnp.int32)
            first_lane = jnp.where(same, jj[None, None, :], lb).min(-1)
            link_id = base + first_lane
            is_first = expanding & (first_lane == jj[None, :])
            link_add = jnp.where(is_first, link_id + 1, 0).astype(jnp.int16)

            upd = lambda arr, u: jax.lax.dynamic_update_slice_in_dim(
                arr, u, base, axis=1)
            tree = tree.replace(
                node_board=upd(tree.node_board, stepped.board),
                node_to_play=upd(tree.node_to_play, stepped.to_play),
                node_last=upd(tree.node_last, stepped.last_move),
                node_count=upd(tree.node_count, stepped.move_count),
                node_done=upd(tree.node_done, stepped.done),
                node_winner=upd(tree.node_winner, stepped.winner),
                child=tree.child.at[earange[:, None], lps, safe_act].add(
                    link_add),
            )

            logits_f, v_f = evaluate(flat(leaf_state.board),
                                     flat(leaf_state.to_play),
                                     flat(leaf_state.last_move), keval)
            logits, v = unflat(logits_f), unflat(v_f)
            leaf_value = jnp.where(
                leaf_state.done,
                (leaf_state.winner * leaf_state.to_play).astype(jnp.float32),
                v.astype(jnp.float32))
            child_legal = stepped.board == 0
            child_p = masked_softmax(logits, child_legal)
            tree = tree.replace(p=upd(
                tree.p,
                jnp.where(child_legal, child_p, -1.0).astype(prior_dtype)))

            dn = jnp.arange(d)[None, None, :]
            on_path = dn < deps[:, :, None]
            exp_ = (deps[:, :, None] - dn).astype(jnp.int32)
            sign = jnp.where(exp_ % 2 == 0, 1.0, -1.0)
            vals = jnp.where(on_path, sign * leaf_value[:, :, None], 0.0)
            if fixed_w:
                vals = jnp.round(vals * w_scale).astype(jnp.int16)
            eidx = earange[:, None, None]
            tree = tree.replace(
                n=tree.n.at[eidx, pns, pas].add(on_path.astype(jnp.uint16)),
                w=tree.w.at[eidx, pns, pas].add(vals))
            return tree, cand, key

        return pass_body

    base0 = 1
    for gi, (lb, passes) in enumerate(schedule):
        if cand.shape[1] != lb:  # halve: keep the top-lb survivors
            sc = cand_scores(tree, cand)
            _, keep = jax.lax.top_k(sc, lb)
            cand = jnp.take_along_axis(cand, keep.astype(jnp.int32), axis=1)
        tree, cand, key = jax.lax.fori_loop(
            0, passes, make_pass(lb, base0), (tree, cand, key))
        base0 += lb * passes

    # final action: best surviving candidate by g + logits + σ(q̂)
    sc = cand_scores(tree, cand)
    action = jnp.take_along_axis(
        cand, jnp.argmax(sc, axis=1)[:, None], axis=1)[:, 0]

    n0, q = root_stats(tree)
    n_sum = n0.sum(-1)
    w_root = tree.w[:, 0, :].astype(jnp.float32).sum(-1) / w_scale
    root_value = jnp.where(n_sum > 0, w_root / jnp.maximum(n_sum, 1.0), 0.0)

    pi_target = _pi_target(root_logits, root_legal, root_p, root_v,
                           n0, q, c_visit, c_scale)

    return GumbelResult(visits=n0, root_value=root_value, priors=root_p,
                        action=action.astype(jnp.int32),
                        pi_target=pi_target)


def _pi_target(root_logits, root_legal, root_p, root_v, n0, q,
               c_visit, c_scale):
    """Improved policy π' = softmax(logits + σ(completed Q)) (paper §4):
    unvisited actions complete with the mixed value estimate
    v_mix = (v_net + ΣN · Σ_visited π q / Σ_visited π) / (1 + ΣN).
    All inputs are ACTION-space [E, A] (q is W/N where visited, else 0)."""
    n_sum = n0.sum(-1)
    visited = n0 > 0
    pi_vis = jnp.where(visited, root_p, 0.0)
    sum_pi_vis = pi_vis.sum(-1)
    wq = (pi_vis * q).sum(-1) / jnp.maximum(sum_pi_vis, 1e-30)
    v_mix = jnp.where(
        sum_pi_vis > 0,
        (root_v.astype(jnp.float32) + n_sum * wq) / (1.0 + n_sum),
        root_v.astype(jnp.float32))
    completed = jnp.where(visited, q, v_mix[:, None])
    return masked_softmax(
        root_logits + _sigma_q(n0, completed, c_visit, c_scale), root_legal)


def _run_gumbel_capped(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Evaluator,
    state: EnvState,
    key: jax.Array,
    *,
    sims: int,
    add_noise: bool,
    gumbel: Optional[jnp.ndarray],
) -> GumbelResult:
    """Gumbel sequential halving over the branch-capped slot tree
    (mcts/search_capped.py — the production layout at 15×15/19×19).

    Layout marriage: the root's slot table is built from the top-m
    candidates BY g + logits (not by prior — below the root, slots stay
    prior-ordered as usual), so halving lane j IS root slot j and the
    forced-root hook in search_capped._select_lanes just overrides the
    depth-0 slot choice. Distinct slots lead to disjoint subtrees, so the
    wavefront's computed virtual visits are zero except for deliberately
    duplicated lanes (envs with fewer than m legal moves map their illegal
    candidates onto slot 0, sharing its subtree — the same duplicate-lane
    semantics as the uncapped driver's action duplication). Everything
    below the root — wavefront descent, dedup expansion, packed-s32 stats,
    one batched forward per pass — is search_capped._run_pass verbatim.

    Interior nodes keep the top-C-by-prior cap; the root keeps ALL of the
    gumbel candidates (m <= C asserted), so no candidate the halving
    schedule wants to visit is ever slot-dropped."""
    from alphafive_tpu.mcts.search_capped import (CappedTree, _run_pass,
                                                  _top_c)

    e, a = state.board.shape
    c = min(int(mcts_cfg.branch_cap), a)
    schedule = build_schedule(sims, min(int(mcts_cfg.gumbel_m), a, c))
    m = schedule[0][0]
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (jnp.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else jnp.float32)
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    value_dtype = jnp.int16 if fixed_w else jnp.float32
    w_scale = 64.0 if fixed_w else 1.0
    packed = fixed_w
    c_puct = jnp.float32(mcts_cfg.c_puct)
    c_visit = float(mcts_cfg.gumbel_c_visit)
    c_scale = float(mcts_cfg.gumbel_c_scale)
    assert nn <= 32767
    assert c <= 256, "branch_cap must be <= 256 (path packs slot in 8 bits)"

    key, kg, keval = jax.random.split(key, 3)

    if packed:
        stats = dict(n=jnp.zeros((e, nn, c), jnp.int32), w=None)
    else:
        stats = dict(n=jnp.zeros((e, nn, c), jnp.uint16),
                     w=jnp.zeros((e, nn, c), value_dtype))
    tree = CappedTree(
        **stats,
        p=jnp.full((e, nn, c), -1.0, prior_dtype),
        child=jnp.full((e, nn, c), -1, jnp.int16),
        cand_act=jnp.zeros((e, nn, c), jnp.int16),
        node_done=jnp.zeros((e, nn), bool),
        node_winner=jnp.zeros((e, nn), jnp.int8),
        node_to_play=jnp.ones((e, nn), jnp.int8),
        node_last=jnp.full((e, nn), -1, jnp.int32),
        node_count=jnp.zeros((e, nn), jnp.int32),
        node_board=jnp.zeros((e, nn, a), jnp.int8),
    )
    tree = tree.replace(
        node_board=tree.node_board.at[:, 0].set(state.board),
        node_to_play=tree.node_to_play.at[:, 0].set(state.to_play),
        node_last=tree.node_last.at[:, 0].set(state.last_move),
        node_count=tree.node_count.at[:, 0].set(state.move_count),
        node_done=tree.node_done.at[:, 0].set(state.done),
        node_winner=tree.node_winner.at[:, 0].set(state.winner),
    )

    root_logits, root_v = evaluate(state.board, state.to_play,
                                   state.last_move, keval)
    root_logits = root_logits.astype(jnp.float32)
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)

    if gumbel is not None:
        g = gumbel.astype(jnp.float32)
    elif add_noise:
        g = jax.random.gumbel(kg, (e, a), jnp.float32)
    else:
        g = jnp.zeros((e, a), jnp.float32)
    glogits = jnp.where(root_legal, g + root_logits, -jnp.inf)

    # top-m candidates by g + logits become root slots 0..m-1 (EXACT
    # top_k: a dropped root candidate would get zero π' mass). Envs with
    # fewer than m legal moves map their illegal candidates onto slot 0 —
    # duplicate lanes share the best slot's subtree.
    _, cand = jax.lax.top_k(glogits, m)                        # [E, m]
    cand = cand.astype(jnp.int32)
    cand_legal = jnp.take_along_axis(root_legal, cand, axis=1)
    cand_act_root = jnp.where(cand_legal, cand, cand[:, :1])
    cand_slots = jnp.where(cand_legal,
                           jnp.arange(m, dtype=jnp.int32)[None, :], 0)
    slot_p = jnp.where(cand_legal,
                       jnp.take_along_axis(root_p, cand_act_root, axis=1),
                       -1.0)
    p_row = jnp.full((e, c), -1.0, jnp.float32).at[:, :m].set(slot_p)
    act_row = jnp.zeros((e, c), jnp.int16).at[:, :m].set(
        cand_act_root.astype(jnp.int16))
    tree = tree.replace(
        p=tree.p.at[:, 0].set(p_row.astype(prior_dtype)),
        cand_act=tree.cand_act.at[:, 0].set(act_row))
    # g + logits per root SLOT (illegal/pad slots -inf; only slots that
    # cand_slots can reference ever compete in the halving top_k)
    glogits_slot = jnp.full((e, c), -jnp.inf).at[:, :m].set(
        jnp.where(cand_legal,
                  jnp.take_along_axis(glogits, cand_act_root, axis=1),
                  -jnp.inf))

    earange = jnp.arange(e)

    def root_stats(tree):
        if packed:
            row = tree.n[:, 0, :]
            n0 = (row & 0xFFFF).astype(jnp.float32)            # [E, C]
            w0 = (row >> 16).astype(jnp.float32) / w_scale
        else:
            n0 = tree.n[:, 0, :].astype(jnp.float32)
            w0 = tree.w[:, 0, :].astype(jnp.float32) / w_scale
        q = jnp.where(n0 > 0, w0 / jnp.maximum(n0, 1.0), 0.0)
        return n0, w0, q

    def cand_scores(tree, cand_slots):
        """g + logits + σ(q̂) at the current survivor slots ([E, lanes])."""
        n0, _, q = root_stats(tree)
        score_all = glogits_slot + _sigma_q(n0, q, c_visit, c_scale)
        return jnp.take_along_axis(score_all, cand_slots, axis=1)

    base0 = 1
    done_passes = 0
    for lb, passes in schedule:
        if cand_slots.shape[1] != lb:  # halve: keep the top-lb survivors
            sc = cand_scores(tree, cand_slots)
            _, keep = jax.lax.top_k(sc, lb)
            cand_slots = jnp.take_along_axis(
                cand_slots, keep.astype(jnp.int32), axis=1)
        # a descent in global pass p records at most p + 1 edges (the tree
        # deepens by <= 1 level per pass), so this group's static depth
        # cap only needs to reach done_passes + passes
        d_group = max(1, min(depth_limit, done_passes + passes))
        forced = cand_slots

        def group_body(i, carry, lb=lb, d_group=d_group, forced=forced,
                       base0=base0):
            tree, key = carry
            tree, key, _ = _run_pass(
                env_cfg, evaluate, tree, key, base=base0 + i * lb,
                d=d_group, lb=lb, c=c, packed=packed, fixed_w=fixed_w,
                w_scale=w_scale, prior_dtype=prior_dtype, c_puct=c_puct,
                forced_k=jnp.float32(0.0), forced_slots=forced)
            return tree, key

        tree, key = jax.lax.fori_loop(0, passes, group_body, (tree, key))
        base0 += lb * passes
        done_passes += passes

    # final action: best surviving candidate by g + logits + σ(q̂)
    sc = cand_scores(tree, cand_slots)
    act0 = tree.cand_act[:, 0, :].astype(jnp.int32)            # [E, C]
    cand_acts = jnp.take_along_axis(act0, cand_slots, axis=1)
    action = jnp.take_along_axis(
        cand_acts, jnp.argmax(sc, axis=1)[:, None], axis=1)[:, 0]

    # scatter slot stats back onto the action space (duplicated slots —
    # the <m-legal case — merge by summing N and W, then re-deriving Q)
    n0, w0, _ = root_stats(tree)
    visits = jnp.zeros((e, a), jnp.float32).at[
        earange[:, None], act0].add(n0)
    w_a = jnp.zeros((e, a), jnp.float32).at[
        earange[:, None], act0].add(w0)
    q_a = jnp.where(visits > 0, w_a / jnp.maximum(visits, 1.0), 0.0)
    n_sum = n0.sum(-1)
    root_value = jnp.where(n_sum > 0,
                           w0.sum(-1) / jnp.maximum(n_sum, 1.0), 0.0)

    pi_target = _pi_target(root_logits, root_legal, root_p, root_v,
                           visits, q_a, c_visit, c_scale)
    return GumbelResult(visits=visits, root_value=root_value, priors=root_p,
                        action=action.astype(jnp.int32),
                        pi_target=pi_target)
