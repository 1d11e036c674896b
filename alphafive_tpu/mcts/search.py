"""Batched on-device MCTS over fixed-size tree arrays.

Accelerator-first replacement for the reference's recursive Python MCTS
(SURVEY.md §3.2, BASELINE.json north star: "fully on-device batched MCTS in
JAX — fixed-size tree arrays per env, vmapped PUCT selection/expansion/backup,
Dirichlet root noise"). Design:

  * One simulation expands exactly one node, so node ids are pre-assigned
    — no dynamic allocation, no host control flow. The sim loop runs in
    PASSES of ``leaf_batch`` simulations: each pass selects that many
    leaves per env (virtual visits between descents keep lanes apart),
    expands them all in one batched env.step, and evaluates all
    E·leaf_batch leaves in ONE network forward — the reference evaluates
    leaves one state at a time through ``session.run`` (batch size 1, its
    key inefficiency, SURVEY.md §3.1). leaf_batch=1 is exactly sequential
    MCTS.
  * Selection is a vmapped per-env ``lax.while_loop`` recording each descent
    path into fixed ``[depth_limit]`` buffers; the carried state is
    O(depth), not the tree (see _select_one's perf note for why vmap beats
    a batch-level loop here).
  * Backup is a single batched scatter-add along the recorded paths with
    sign-alternating values — no while_loop over tree-sized carries.
  * ``branch_cap`` switches to the slot-indexed top-C tree layout in
    mcts/search_capped.py (the production perf configuration).

Conventions are documented (and mirrored in NumPy) in mcts/reference.py;
tests/test_mcts.py asserts equal visit counts on frozen evaluators.

Memory (SURVEY.md §5.7): edge arrays are [E, N+1, A] (N=simulations,
A=board²). 15×15/400 sims/256 envs ≈ 0.9 GB in f32+i32 — int8 boards and
bf16 priors keep the 19×19/10-block config (BASELINE.json:11) in budget via
``prior_dtype``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.utils import pytree

# evaluator: (board int8[E,A], to_play int8[E], last int32[E], key)
#            -> (logits f32[E,A], value f32[E])
Evaluator = Callable[..., Tuple[jnp.ndarray, jnp.ndarray]]


@pytree.dataclass
class Tree:
    # edge stats [E, NN, A]
    n: jnp.ndarray        # uint16 visit counts (<= sims+1 by construction)
    w: jnp.ndarray        # f32 total value (parent's to-play perspective)
    p: jnp.ndarray        # priors (prior_dtype)
    child: jnp.ndarray    # int16 child node index, -1 if unexpanded
    # node stats [E, NN]
    node_done: jnp.ndarray    # bool
    node_winner: jnp.ndarray  # int8
    node_to_play: jnp.ndarray  # int8
    node_last: jnp.ndarray    # int32
    node_count: jnp.ndarray   # int32 move count
    node_board: jnp.ndarray   # int8 [E, NN, A]


class SearchResult(NamedTuple):
    visits: jnp.ndarray      # f32[E, A] root visit counts
    root_value: jnp.ndarray  # f32[E] W(root)/N(root)
    priors: jnp.ndarray      # f32[E, A] root priors (after noise)


def masked_softmax(logits: jnp.ndarray, legal: jnp.ndarray) -> jnp.ndarray:
    """Softmax over legal entries only (same op order as the NumPy oracle).

    Rows with no legal action (terminal nodes — priors unused) return zeros
    rather than NaN so JAX_DEBUG_NANS stays usable (SURVEY.md §5.2).
    """
    x = jnp.where(legal, logits.astype(jnp.float32), -jnp.inf)
    m = jnp.max(x, axis=-1, keepdims=True)
    ex = jnp.where(legal, jnp.exp(x - jnp.where(jnp.isfinite(m), m, 0.0)),
                   0.0)
    return ex / jnp.maximum(jnp.sum(ex, axis=-1, keepdims=True), 1e-30)


def dirichlet_noise(key: jax.Array, alpha: float,
                    legal: jnp.ndarray) -> jnp.ndarray:
    """Dirichlet(α) over each env's legal moves (zero on illegal)."""
    g = jax.random.gamma(key, alpha, shape=legal.shape, dtype=jnp.float32)
    g = jnp.where(legal, g, 0.0)
    return g / jnp.maximum(g.sum(-1, keepdims=True), 1e-30)


def _tree_init(env_cfg: EnvConfig, num_envs: int, num_nodes: int,
               prior_dtype, value_dtype=jnp.float32) -> Tree:
    e, nn, a = num_envs, num_nodes, env_cfg.num_actions
    # dtype choices are memory-bandwidth choices: the select loop makes XLA
    # relayout every tree array once per simulation, so halving n/child
    # (u16/i16) directly cuts the dominant memory traffic.
    assert nn <= 32767, "int16 child pointers cap the tree at 32767 nodes"
    return Tree(
        n=jnp.zeros((e, nn, a), jnp.uint16),
        w=jnp.zeros((e, nn, a), value_dtype),
        p=jnp.zeros((e, nn, a), prior_dtype),
        child=jnp.full((e, nn, a), -1, jnp.int16),
        node_done=jnp.zeros((e, nn), bool),
        node_winner=jnp.zeros((e, nn), jnp.int8),
        node_to_play=jnp.ones((e, nn), jnp.int8),
        node_last=jnp.full((e, nn), -1, jnp.int32),
        node_count=jnp.zeros((e, nn), jnp.int32),
        node_board=jnp.zeros((e, nn, a), jnp.int8),
    )


def _puct_scores(n_row, w_row, p_row, legal, c_puct):
    """PUCT over one node's actions. Same op order as the NumPy oracle."""
    return _puct_scores_n(n_row.astype(jnp.float32), w_row, p_row, legal,
                          c_puct)


def _puct_scores_n(nf, w_row, p_row, legal, c_puct):
    """PUCT with float visit counts (virtual visits already folded in)."""
    q = jnp.where(nf > 0, w_row / jnp.maximum(nf, 1.0), 0.0)
    ns = 1.0 + jnp.sum(nf, axis=-1, keepdims=True)
    u = c_puct * p_row.astype(jnp.float32) * jnp.sqrt(ns) / (1.0 + nf)
    return jnp.where(legal, q + u, -jnp.inf)


def _select_one(tree_n, tree_w, tree_p, tree_child, tree_done, vroot,
                c_puct, depth_limit, w_inv_scale=1.0, forced_k=0.0,
                root_action=None):
    """Single-env PUCT descent (vmapped over envs by the caller).

    `root_action` (trace-time optional, int32[] when given) pins the
    FIRST step of the descent to a fixed root child — the Gumbel search's
    sequential-halving lanes (mcts/gumbel.py) descend PUCT below a forced
    root edge. None (the default) leaves the classic path untouched.

    `vroot[A]` holds the pass's virtual root visits (leaf-parallel search):
    edges already claimed by earlier lanes of the same pass count as
    visited AT THE ROOT, steering later lanes toward different subtrees.
    Root-only is a deliberate trade: scattering virtual visits into the
    full [NN, A] visit array costs a full-array copy + relayout per
    descent (the bottleneck where this was first tuned), while
    the [A] root row is a register-cheap carry. Lanes that still converge
    below the root merely revisit the same leaf (handled by the duplicate
    dedup at expansion — a small budget overlap, not an error).

    Legality comes from the prior's sign (illegal cells store -1 — see
    run_mcts), so the cached boards never enter this loop.

    Perf note: under vmap, XLA picks an env-minor layout for the tree arrays
    inside this while_loop and pays one transpose per array per simulation.
    On the accelerator this was first tuned for that beat a batch-level
    while_loop with standard-layout row gathers, whose gathers/scatters
    carried a large fixed cost per op; it is unmeasured on the GPU. Every
    array this loop touches is relaid-out once per simulation, so the
    hot-loop set is kept minimal (u16 n, i16 child, prior_dtype p, f32 w;
    boards excluded via the sign trick).

    Returns (leaf_parent, action, depth, path_nodes[D], path_actions[D]).
    A lane stops at the first missing child (to expand), at a terminal node,
    or at the depth cap (the latter two: action = -1, leaf revisit —
    mctx-style truncation). The path records every traversed edge INCLUDING
    the stopping edge when expanding. Unused path slots stay (0, 0) and
    carry zero-valued updates in the backup scatter (a plain scatter-add
    with in-bounds pads; OOB-dropped and sorted/unique variants measured
    slower where this was first tuned).
    """
    d = depth_limit

    def cond(c):
        return ~c[2]

    def body(c):
        cur, _, _, depth, pn, pa = c
        revisit = tree_done[cur] | (depth >= d)
        p_signed = tree_p[cur].astype(jnp.float32)
        legal = p_signed >= 0
        w_row = tree_w[cur].astype(jnp.float32) * w_inv_scale
        p_row = jnp.maximum(p_signed, 0.0)
        nf_real = tree_n[cur].astype(jnp.float32)
        nf = jnp.where(cur == 0, nf_real + vroot, nf_real)  # virtual visits
        score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
        # forced playouts (KataGo §3.4, config.forced_playouts_k): at the
        # root, a visited child still owed forced visits outranks
        # everything. The gate uses REAL visits (KataGo's definition): a
        # child with only a virtual visit must not become force-selected,
        # or every lane of a pass would funnel onto it — the opposite of
        # what virtual visits are for. (In "path" virtual mode real and
        # virtual visits share the array, so the gate is approximate
        # within a pass; presets combining forced playouts with
        # leaf_batch>1 should prefer the branch-capped search, which keeps
        # them separate.)
        forced = (legal & (depth == 0) & (nf_real > 0)
                  & (nf_real * nf_real < forced_k * p_row * jnp.sum(nf_real)))
        score = jnp.where(forced, jnp.inf, score)
        a = jnp.argmax(score).astype(jnp.int32)
        if root_action is not None:  # Gumbel lane: pin the root edge
            a = jnp.where(depth == 0, root_action, a)
        ch = tree_child[cur, a].astype(jnp.int32)
        stop = revisit | (ch < 0)
        rec = ~revisit
        slot = jnp.minimum(depth, d - 1)
        pn = pn.at[slot].set(jnp.where(rec, cur, pn[slot]))
        pa = pa.at[slot].set(jnp.where(rec, a, pa[slot]))
        depth = depth + rec.astype(jnp.int32)
        nxt = jnp.where(stop, cur, ch)
        act = jnp.where(revisit, -1, a)
        return (nxt, act, stop, depth, pn, pa)

    init = (jnp.int32(0), jnp.int32(-1), jnp.array(False), jnp.int32(0),
            jnp.zeros((d,), jnp.int32),
            jnp.zeros((d,), jnp.int32))
    cur, act, _, depth, pn, pa = jax.lax.while_loop(cond, body, init)
    return cur, act, depth, pn, pa


def _gather_env(tree: Tree, idx: jnp.ndarray) -> EnvState:
    """EnvState of node idx[E] in each env's tree."""
    e = jnp.arange(idx.shape[0])
    return EnvState(
        board=tree.node_board[e, idx],
        to_play=tree.node_to_play[e, idx],
        last_move=tree.node_last[e, idx],
        move_count=tree.node_count[e, idx],
        done=tree.node_done[e, idx],
        winner=tree.node_winner[e, idx],
    )


def _gather_env_lanes(tree: Tree, idx: jnp.ndarray) -> EnvState:
    """EnvStates of nodes idx[E, L] in each env's tree (leading [E, L])."""
    e = jnp.arange(idx.shape[0])[:, None]
    return EnvState(
        board=tree.node_board[e, idx],
        to_play=tree.node_to_play[e, idx],
        last_move=tree.node_last[e, idx],
        move_count=tree.node_count[e, idx],
        done=tree.node_done[e, idx],
        winner=tree.node_winner[e, idx],
    )


def run_mcts(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Evaluator,
    state: EnvState,
    key: jax.Array,
    *,
    num_simulations: Optional[int] = None,
    add_noise: bool = True,
) -> SearchResult:
    """Search every env's current position. Roots must not be terminal
    (done envs are searched harmlessly but their visits are meaningless —
    callers reset or mask them).
    """
    if mcts_cfg.branch_cap is not None:
        from alphafive_tpu.mcts.search_capped import run_mcts_capped
        return run_mcts_capped(env_cfg, mcts_cfg, evaluate, state, key,
                               num_simulations=num_simulations,
                               add_noise=add_noise)
    sims = int(num_simulations or mcts_cfg.num_simulations)
    e, a = state.board.shape
    nn = sims + 1
    # worst case is a single chain of sims edges; perf presets cap it
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (jnp.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else jnp.float32)
    # fixed-point value sums (config.MCTSConfig.value_dtype): W stored as
    # int16 in 1/64 steps; |W| <= 64*(sims+1) must fit int16. Budgets that
    # don't fit (e.g. big pure-MCTS anchor searches reusing a perf preset's
    # mcts config) fall back to exact float32 sums rather than crashing
    # (ADVICE.md round-1 high: eval at >=512 anchor rollouts).
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    value_dtype = jnp.int16 if fixed_w else jnp.float32
    w_scale = 64.0 if fixed_w else 1.0
    c_puct = jnp.float32(mcts_cfg.c_puct)
    # forced playouts only perturb noisy self-play searches
    forced_k = jnp.float32(mcts_cfg.forced_playouts_k if add_noise else 0.0)

    key, knoise, keval = jax.random.split(key, 3)

    tree = _tree_init(env_cfg, e, nn, prior_dtype, value_dtype)
    # root = node 0
    tree = tree.replace(
        node_board=tree.node_board.at[:, 0].set(state.board),
        node_to_play=tree.node_to_play.at[:, 0].set(state.to_play),
        node_last=tree.node_last.at[:, 0].set(state.last_move),
        node_count=tree.node_count.at[:, 0].set(state.move_count),
        node_done=tree.node_done.at[:, 0].set(state.done),
        node_winner=tree.node_winner.at[:, 0].set(state.winner),
    )
    root_logits, _ = evaluate(state.board, state.to_play, state.last_move,
                              keval)
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)
    if add_noise:
        noise = dirichlet_noise(knoise, mcts_cfg.dirichlet_alpha, root_legal)
        eps = jnp.float32(mcts_cfg.dirichlet_eps)
        root_p = (1.0 - eps) * root_p + eps * noise
    # priors are stored sign-masked: legal cells hold p, illegal cells -1,
    # so selection derives legality from the prior row and never touches
    # the cached boards (one fewer relayout + gather per simulation)
    tree = tree.replace(p=tree.p.at[:, 0].set(
        jnp.where(root_legal, root_p, -1.0).astype(prior_dtype)))

    earange = jnp.arange(e)
    select_v = jax.vmap(_select_one,
                        in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None))

    # Leaf-parallel search: `lb` descents share one pass — their visit
    # increments are scattered onto the path edges at SELECT time ("virtual
    # visits", so lanes diverge near the frontier), the value lands at
    # backup. With lb=1 this is bit-identical to fully sequential MCTS
    # (visit placement moves earlier but nothing reads between), which the
    # oracle-parity tests pin. With lb>1 it amortizes the per-simulation
    # net-forward launch AND the w/p/child relayout traffic ~lb-fold — the
    # round-1 measured bottleneck (docs/PERFORMANCE.md).
    lb = max(1, int(mcts_cfg.leaf_batch))
    while sims % lb:
        lb -= 1  # runtime budgets (e.g. PCR small searches) round down to
        #          the largest divisor of sims; presets pick divisible pairs
    passes = sims // lb
    d = depth_limit

    def pass_body(p, carry):
        tree, key = carry
        key, keval = jax.random.split(key)

        # --- select lb leaves, virtual visits between descents ------------
        # "root" mode mutates ONLY the [E, A] vroot carry between lanes —
        # the big tree arrays stay untouched for the whole select phase, so
        # their scatter→gather relayout happens once per pass (the round-1
        # measured bottleneck). "path" mode additionally scatters +1 onto
        # every traversed edge of the visit array (one [E,NN,A] relayout
        # per descent — slower, but deep descents keep diverging:
        # markedly stronger at equal budget, docs/PERFORMANCE.md).
        path_virtual = mcts_cfg.virtual_mode == "path" and lb > 1

        def one_descent(j, c):
            n_cur, vroot, lps, acts, deps, pns, pas = c
            lp, act, depth, pn, pa = select_v(
                n_cur, tree.w, tree.p, tree.child, tree.node_done, vroot,
                c_puct, d, 1.0 / w_scale, forced_k)
            dn_ = jnp.arange(d)[None, :]
            on_path_ = dn_ < depth[:, None]
            if path_virtual:
                n_cur = n_cur.at[earange[:, None], pn, pa].add(
                    on_path_.astype(jnp.uint16))
            else:
                root_edge = pa[:, 0]   # first traversed edge (if depth>0)
                vroot = vroot.at[earange, root_edge].add(
                    (depth > 0).astype(jnp.float32))
            return (n_cur, vroot,
                    lps.at[:, j].set(lp), acts.at[:, j].set(act),
                    deps.at[:, j].set(depth),
                    pns.at[:, j].set(pn), pas.at[:, j].set(pa))

        init = (tree.n, jnp.zeros((e, a), jnp.float32),
                jnp.zeros((e, lb), jnp.int32), jnp.zeros((e, lb), jnp.int32),
                jnp.zeros((e, lb), jnp.int32),
                jnp.zeros((e, lb, d), jnp.int32),
                jnp.zeros((e, lb, d), jnp.int32))
        n_virt, _, lps, acts, deps, pns, pas = jax.lax.fori_loop(
            0, lb, one_descent, init)
        if path_virtual:
            # the virtual visits ARE the real visits (backup adds w only)
            tree = tree.replace(n=n_virt)

        # revisit lanes (action = -1): terminal node OR live node at the
        # depth cap — no expansion, back up the leaf's own value
        is_revisit = acts < 0                      # [E, lb]
        safe_act = jnp.maximum(acts, 0)

        parent_state = _gather_env_lanes(tree, lps)          # [E, lb, ...]
        flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
        unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
        stepped_f = vector.step(env_cfg, jax.tree.map(flat, parent_state),
                                flat(safe_act))
        stepped = jax.tree.map(unflat, stepped_f)
        # leaf state: the stepped child for expanding lanes, the selected
        # node itself for revisit lanes (step would place a bogus stone on a
        # live depth-capped node)

        def sel(a_, b_):
            m = is_revisit.reshape(is_revisit.shape
                                   + (1,) * (a_.ndim - 2))
            return jnp.where(m, a_, b_)

        leaf_state = jax.tree.map(sel, parent_state, stepped)

        base = 1 + p * lb                          # first node id this pass
        new_ids = base + jnp.arange(lb, dtype=jnp.int32)      # [lb]

        # duplicate expansions (two lanes stopping at the SAME unexpanded
        # edge): all duplicates resolve to the FIRST lane's node id, so the
        # child-link scatter writes one value per edge. The later lanes'
        # node slots become identical-content orphans (their backed-up
        # values are evaluations of the same position — consistent).
        edge_key = lps * a + safe_act                          # [E, lb]
        expanding = ~is_revisit
        same = ((edge_key[:, :, None] == edge_key[:, None, :])
                & expanding[:, :, None] & expanding[:, None, :])  # [E,lb,lb]
        jj = jnp.arange(lb, dtype=jnp.int32)
        first_lane = jnp.where(same, jj[None, None, :], lb).min(-1)  # [E,lb]
        link_id = base + first_lane                            # [E, lb]
        is_first = expanding & (first_lane == jj[None, :])
        # child starts at -1 and no selected edge has an existing child
        # (descents stop at missing children), so `add(link_id + 1)` writes
        # the link with a COMMUTATIVE scatter: lane collisions are only
        # ever 0-adds from revisit/duplicate lanes — no write races.
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

        # ONE batched evaluation per pass: all E·lb leaves in one forward
        logits_f, v_f = evaluate(flat(leaf_state.board),
                                 flat(leaf_state.to_play),
                                 flat(leaf_state.last_move), keval)
        logits, v = unflat(logits_f), unflat(v_f)
        leaf_value = jnp.where(
            leaf_state.done,
            (leaf_state.winner * leaf_state.to_play).astype(jnp.float32),
            v.astype(jnp.float32))                             # [E, lb]
        child_legal = stepped.board == 0
        child_p = masked_softmax(logits, child_legal)
        tree = tree.replace(p=upd(
            tree.p,
            jnp.where(child_legal, child_p, -1.0).astype(prior_dtype)))

        # batched backup of all lb paths: edge j on a path (0-based from
        # root, depth L) accumulates leaf_value * (-1)^(L - j) and one
        # visit; pad slots add 0 at (0, 0)
        dn = jnp.arange(d)[None, None, :]                      # [1, 1, D]
        on_path = dn < deps[:, :, None]                        # [E, lb, D]
        exp_ = (deps[:, :, None] - dn).astype(jnp.int32)
        sign = jnp.where(exp_ % 2 == 0, 1.0, -1.0)
        vals = jnp.where(on_path, sign * leaf_value[:, :, None], 0.0)
        if fixed_w:
            vals = jnp.round(vals * w_scale).astype(jnp.int16)
        eidx = earange[:, None, None]
        new_w = tree.w.at[eidx, pns, pas].add(vals)
        if path_virtual:  # visits already placed at select time
            tree = tree.replace(w=new_w)
        else:
            tree = tree.replace(
                n=tree.n.at[eidx, pns, pas].add(on_path.astype(jnp.uint16)),
                w=new_w)
        return tree, key

    tree, _ = jax.lax.fori_loop(0, passes, pass_body, (tree, key))

    visits = tree.n[:, 0, :].astype(jnp.float32)
    n_sum = visits.sum(-1)
    w_root = tree.w[:, 0, :].astype(jnp.float32).sum(-1) / w_scale
    root_value = jnp.where(n_sum > 0, w_root
                           / jnp.maximum(n_sum, 1.0), 0.0)
    return SearchResult(visits=visits, root_value=root_value,
                        priors=root_p)


def pi_from_visits(visits: jnp.ndarray, temperature: jnp.ndarray,
                   greedy: jnp.ndarray) -> jnp.ndarray:
    """π ∝ N^(1/τ), in log space; greedy[E] lanes get one-hot argmax.

    Matches the reference family's visit-count→π with temperature decay
    (SURVEY.md §2 "MCTS player").
    """
    logn = jnp.where(visits > 0, jnp.log(visits), -jnp.inf)
    scaled = logn / jnp.maximum(temperature[:, None], 1e-6)
    scaled = scaled - scaled.max(-1, keepdims=True)
    pi = jnp.where(jnp.isfinite(scaled), jnp.exp(scaled), 0.0)
    pi = pi / jnp.maximum(pi.sum(-1, keepdims=True), 1e-30)
    onehot = jax.nn.one_hot(jnp.argmax(visits, axis=-1), visits.shape[-1])
    return jnp.where(greedy[:, None], onehot, pi)


def sample_actions(key: jax.Array, pi: jnp.ndarray) -> jnp.ndarray:
    """Sample one action per env from π (guarded against all-zero rows)."""
    logits = jnp.where(pi > 0, jnp.log(pi), -jnp.inf)
    safe = jnp.where(jnp.isfinite(logits).any(-1, keepdims=True), logits, 0.0)
    return jax.random.categorical(key, safe, axis=-1).astype(jnp.int32)
