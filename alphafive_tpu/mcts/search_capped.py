"""Branch-capped batched MCTS: slot-indexed trees over top-C children.

Same search semantics as mcts/search.py (PUCT select / expand / batched
evaluate / scatter backup, leaf-parallel passes with virtual visits) with
one structural change: every node stores only its top-``branch_cap``
children BY PRIOR, so all edge arrays are [E, NN, C] instead of
[E, NN, A]. The tree's full-array scatter→gather relayout traffic — the
measured round-1/round-2 throughput bottleneck (docs/PERFORMANCE.md) —
shrinks by A/C (3.5× at 15×15 / C=64, 5.6× at 19×19), and every select
step's row gathers and PUCT math shrink the same way.

Approximation vs the exact search (run_mcts with branch_cap=None): a
node's children outside its top-C priors are unreachable. With C=64 and
400-sim budgets the exact search visits far fewer than 64 children per
node, so the cap is usually inactive; the equal-budget strength A/B lives
in docs/PERFORMANCE.md. Everything else matches the exact search: same
PUCT formula, same terminal/value conventions, same noise. Leaf-parallel
passes always use FULL-PATH virtual visits here, computed inside the
descent loop from the recorded path buffers instead of scattered into the
visit array (config.MCTSConfig.virtual_mode is ignored — the compact form
makes "path" as cheap as "root"): the tree arrays stay immutable across
the whole select phase.

The reference family has no analog (its recursive MCTS materializes
children lazily in Python dicts — SURVEY.md §3.2); this is the
array-MCTS equivalent of lazy children.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from alphafive_tpu.config import EnvConfig, MCTSConfig
from alphafive_tpu.env import vector
from alphafive_tpu.env.vector import EnvState
from alphafive_tpu.mcts.search import (Evaluator, SearchResult,
                                       _puct_scores_n, dirichlet_noise,
                                       masked_softmax)

# float32 matrix products that carry exact integers (packed path ids,
# fixed-point values) must not run at reduced precision (TF32 on GPUs)
_EXACT = jax.lax.Precision.HIGHEST
from alphafive_tpu.utils import pytree


@pytree.dataclass
class CappedTree:
    # edge stats [E, NN, C] (slot-indexed)
    n: jnp.ndarray         # visit counts: u16, OR s32 packed
    #                        (value_sum << 16 | visits) in int16 mode
    w: jnp.ndarray         # value sums (value_dtype); None when packed
    p: jnp.ndarray         # priors (prior_dtype); pads/illegal = -1
    child: jnp.ndarray     # int16 child node index, -1 if unexpanded
    cand_act: jnp.ndarray  # int16 action id per slot
    # node stats [E, NN] / [E, NN, A]
    node_done: jnp.ndarray
    node_winner: jnp.ndarray
    node_to_play: jnp.ndarray
    node_last: jnp.ndarray
    node_count: jnp.ndarray
    node_board: jnp.ndarray


def _top_c(p_signed: jnp.ndarray, c: int, prior_dtype, exact: bool = False):
    """(slot priors [..., C], slot actions i16[..., C]) from [..., A]
    SIGNED priors (legal >= 0, illegal = -1 — the sign trick the exact
    search uses, so selection needs no separate legality array).

    Legal moves sort above illegal ones even at prior exactly 0.0 (a
    softmax underflow must stay selectable-by-Q when slots are free, as
    in the uncapped search); pad slots keep -1.

    When the cap actually binds (c < A), INTERIOR nodes ask for
    `approx_max_k` (recall target 0.98). On the GPU and the CPU, XLA
    lowers it to an exact top-k, so there the interior top-c is exact.
    Where it is approximate, it may swap the ~64th-best prior for the
    ~66th (noise next to the cap itself) or drop a low-prior LEGAL move
    in favour of a -1 pad: at an interior node that move becomes
    unreachable, the same class of error as the cap itself. The ROOT is
    different — a dropped root move gets zero π mass in the training
    targets — so callers pass exact=True for the root's single top-c (one
    exact top_k per search, off the hot path). c == A (the
    parity/equality tests) stays exact."""
    if c < p_signed.shape[-1] and not exact:
        vals, idx = jax.lax.approx_max_k(p_signed.astype(jnp.float32), c,
                                         recall_target=0.98)
    else:
        vals, idx = jax.lax.top_k(p_signed, c)
    vals = jnp.where(vals >= 0, vals, -1.0).astype(prior_dtype)
    return vals, idx.astype(jnp.int16)


def _select_lanes(stat_a, stat_b, tree_p, tree_child, tree_done,
                  c_puct, depth_limit, w_inv_scale, forced_k, num_slots,
                  packed, lb, forced_slots=None, pending=None):
    """WAVEFRONT-PIPELINED PUCT descent: all ``lb`` lanes of a pass in
    ONE while_loop. Lane j starts at loop iteration j and every active
    lane takes one step per iteration, so the sequential iteration count
    is (lb - 1 + max depth) instead of the SUM of per-lane depths that
    lb back-to-back vmapped while_loops cost — the round-2 profile
    showed the descent is op-dispatch-bound (thousands of tiny-op loop
    iterations per ply), so ~4× fewer, lb× wider iterations is the
    lever. Control flow per lane is identical to search._select_one;
    rows are [C]-wide and the recorded path holds SLOTS, not actions.

    The stagger gives two invariants:
      * while lane j is active its recorded depth is EXACTLY k - j at
        iteration k, so both the path-entry write and the
        virtual-visit lookup below use STATIC per-iteration one-hot
        vectors over the depth axis — pure broadcast fusions and one
        tiny einsum, no data-dependent scatters/gathers (the v2
        attempt used a generic scatter-add and a 4-D take_along_axis
        here and lost its iteration-count win to their lowering);
      * every earlier lane i < j is strictly deeper (or already
        stopped with its path final), so the entry lane j reads was
        recorded in a PRIOR iteration — the lookup is race-free and
        bit-identical to running the lanes to completion one by one.

    Stats come either as separate (n u16, w) arrays (`packed=False`, the
    exact mode) or as ONE s32 array with the visit count in the low 16
    bits and the int16 fixed-point value sum in the high 16
    (`packed=True`, the production int16 mode): one row gather and one
    backup scatter instead of two — the scatters were the largest
    non-matmul ops in the pass profile. In packed mode `stat_b` is unused
    (dead-code-eliminated), so only one gather runs per step.

    The recorded path packs (node << 8 | slot) into ONE s32 per edge
    (slots < C <= 256; node ids < 32767): one path-buffer write per
    descent step instead of two, and one carried buffer instead of two.

    Virtual visits are COMPUTED, not scattered, and the comparison reads
    ONE depth index, not a window: expansion links every new node to
    exactly one parent edge (same-edge lanes are deduped, links land
    only on child == -1 slots), so the tree is a proper tree and each
    node has a UNIQUE depth — a lane standing at `cur` at depth t can
    only collide with another lane's path entry at index t (an entry at
    any other depth names a node at that other depth, which cannot be
    `cur`). The round-2 implementation scanned a 16-deep window here
    (the most expensive op of the whole search, and silently
    approximate past 16 plies); the single-depth lookup is ~16× cheaper
    and EXACT at every depth up to max_depth
    (tests/test_mcts.py::test_deep_forced_line_virtual_visits pins the
    deep case; test_branch_cap_full_width_matches_exact pins
    bit-equality with the scatter implementation in mcts/search.py).
    The big tree arrays stay IMMUTABLE for the whole select phase
    (their scatter→gather relayout happens once per pass) while
    preserving full-path virtual-visit semantics.

    `pending` (deferred backup, mcts_cfg.backup_interval=2) is the
    PREVIOUS pass's un-materialized results as (ppas_prev [E,LP,D]
    packed path entries, pw_prev s32 [E,LP,D] fixed-point value deltas,
    deps_prev [E,LP]): its REAL visit counts and value sums are folded
    into nf_real/w_row through the same depth-unique one-hot lookup the
    virtual visits use (a pending entry at depth index t names a
    depth-t node, so the lane standing at `cur` at depth t reads
    exactly index t — one extra tiny einsum per step instead of a full
    [E,NN,C] scatter per pass). All adds are exact in f32 (entries
    < 2^23, value units < 2^15·lb), so the search is BIT-IDENTICAL to
    materializing the scatter every pass
    (tests/test_mcts.py::test_deferred_backup_bit_identical).

    Returns (lps [E,LB] leaf-parent nodes, slots [E,LB] chosen slot or
    -1 for revisits, deps [E,LB] recorded path lengths, ppas [E,LB,D]
    packed (node << 8 | slot) path entries)."""
    d = depth_limit
    e = tree_done.shape[0]
    eidx = jnp.arange(e)[:, None]                              # [E,1]
    lanes = jnp.arange(lb)
    slot_ar = jnp.arange(num_slots)
    tri = lanes[:, None] < lanes[None, :]                      # [LBi,LBj]
    darange = jnp.arange(d)

    def cond(st):
        return jnp.any(~st[3])

    def body(st):
        k, cur, depth, stopped, sel, ppas = st
        active = (lanes[None, :] <= k) & ~stopped              # [E,LB]
        revisit = tree_done[eidx, cur] | (depth >= d)
        p_signed = tree_p[eidx, cur].astype(jnp.float32)       # [E,LB,C]
        legal = p_signed >= 0
        if packed:
            row = stat_a[eidx, cur]                            # s32 [E,LB,C]
            nf_real = (row & 0xFFFF).astype(jnp.float32)
            w_row = (row >> 16).astype(jnp.float32) * w_inv_scale
        else:
            nf_real = stat_a[eidx, cur].astype(jnp.float32)
            w_row = stat_b[eidx, cur].astype(jnp.float32) * w_inv_scale
        p_row = jnp.maximum(p_signed, 0.0)

        # STATIC one-hot over the depth axis: active lane j sits at
        # depth k - j exactly (stagger invariant); stopped lanes read
        # garbage but their scores are discarded, and the
        # depth_i > depth_j mask below uses the real depth counters
        oh_d = (jnp.clip(k - lanes, 0, d - 1)[:, None]
                == darange[None, :]).astype(jnp.float32)       # [LBj,D]
        # ent[e,i,j] = ppas[e,i,k-j] via einsum (f32 exact: entries
        # < 2^24, at HIGHEST precision — a TF32 or bf16 matmul would round
        # the packed ids); one tiny matmul instead of a 4-D gather
        ent = jnp.einsum("eid,jd->eij", ppas.astype(jnp.float32),
                         oh_d, precision=_EXACT).astype(jnp.int32)
        match = (tri[None]
                 & (depth[:, :, None] > depth[:, None, :])
                 & ((ent >> 8) == cur[:, None, :]))            # [E,LBi,LBj]
        virt = jnp.sum(
            jnp.where(match[..., None]
                      & ((ent & 255)[..., None] == slot_ar), 1.0, 0.0),
            axis=1)                                            # [E,LBj,C]

        if pending is not None:
            pp, pw, pdep = pending                         # [E,LP,D]×2, [E,LP]
            # entry/value of pending lane m at depth k - j (same static
            # one-hot as above; f32-exact: entries < 2^23, values < 2^15)
            entp = jnp.einsum("emd,jd->emj", pp.astype(jnp.float32),
                              oh_d, precision=_EXACT).astype(jnp.int32)
            wentp = jnp.einsum("emd,jd->emj", pw.astype(jnp.float32),
                               oh_d, precision=_EXACT)     # [E,LP,LBj]
            validp = ((jnp.clip(k - lanes, 0, d - 1)[None, None, :]
                       < pdep[:, :, None])
                      & ((entp >> 8) == cur[:, None, :]))  # [E,LP,LBj]
            slot_hit = (validp[..., None]
                        & ((entp & 255)[..., None] == slot_ar))
            nf_real = nf_real + jnp.sum(
                jnp.where(slot_hit, 1.0, 0.0), axis=1)     # [E,LBj,C]
            w_row = w_row + jnp.sum(
                jnp.where(slot_hit, wentp[..., None], 0.0),
                axis=1) * w_inv_scale

        nf = nf_real + virt
        score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
        # forced-playout gate on REAL visits only (see search._select_one)
        forced = (legal & (depth == 0)[..., None] & (nf_real > 0)
                  & (nf_real * nf_real
                     < forced_k * p_row
                     * jnp.sum(nf_real, axis=-1, keepdims=True)))
        score = jnp.where(forced, jnp.inf, score)
        s = jnp.argmax(score, axis=-1).astype(jnp.int32)       # [E,LB]
        if forced_slots is not None:
            # forced-root hook (gumbel sequential halving): lane j's first
            # step always takes its assigned root slot — distinct slots
            # mean disjoint subtrees, so the virtual-visit matches below
            # stay zero except for deliberately duplicated lanes
            s = jnp.where(depth == 0, forced_slots, s)
        ch = tree_child[eidx, cur, s].astype(jnp.int32)
        stop_now = revisit | (ch < 0)
        rec = active & ~revisit
        # path write as a broadcast fusion against the SAME static
        # one-hot (each (lane, depth) slot is written at most once)
        ppas = ppas + (jnp.where(rec, (cur << 8) | s, 0)[:, :, None]
                       * oh_d.astype(jnp.int32)[None])
        depth = depth + rec.astype(jnp.int32)
        sel = jnp.where(active & stop_now,
                        jnp.where(revisit, -1, s), sel)
        stopped = stopped | (active & stop_now)
        cur = jnp.where(active & ~stop_now, ch, cur)
        return (k + 1, cur, depth, stopped, sel, ppas)

    init = (jnp.int32(0),
            jnp.zeros((e, lb), jnp.int32),
            jnp.zeros((e, lb), jnp.int32),
            jnp.zeros((e, lb), bool),
            jnp.full((e, lb), -1, jnp.int32),
            jnp.zeros((e, lb, d), jnp.int32))
    _, cur, depth, _, sel, ppas = jax.lax.while_loop(cond, body, init)
    return cur, sel, depth, ppas


def _run_pass(env_cfg, evaluate, tree, key, *, base, d, lb, c, packed,
              fixed_w, w_scale, prior_dtype, c_puct, forced_k,
              forced_slots=None, pending=None, defer=False):
    """One leaf-parallel pass over the capped tree: wavefront select of
    `lb` lanes, batched env.step + net forward, dedup expansion at node
    ids [base, base + lb), combined backup scatter. Shared by the classic
    driver (run_mcts_capped) and the gumbel halving driver
    (mcts/gumbel.py), which forces each lane's first step to its assigned
    root slot via `forced_slots` [E, lb].

    Deferred backup (packed mode only): `defer=True` skips the stats
    scatter and returns this pass's results as a pending tuple; the NEXT
    pass receives it as `pending`, folds it into PUCT inside the select
    loop (see _select_lanes), and materializes BOTH passes' deltas in
    one scatter — halving the [E,NN,C] scatter traffic per pass at the
    cost of one extra einsum lookup per descent step. Returns
    (tree, key, pending_out)."""
    e = tree.node_done.shape[0]
    earange = jnp.arange(e)
    key, keval = jax.random.split(key)

    # select lb leaves in one wavefront-pipelined loop; full-path
    # virtual visits computed from the already-recorded path buffers
    # (big tree arrays stay immutable for the whole select phase —
    # see _select_lanes)
    lps, slots, deps, ppas = _select_lanes(
        tree.n, tree.n if packed else tree.w, tree.p, tree.child,
        tree.node_done, c_puct, d, 1.0 / w_scale, forced_k, c,
        packed, lb, forced_slots, pending)
    pns, pas = ppas >> 8, ppas & 255                       # [E, lb, D]

    is_revisit = slots < 0
    safe_slot = jnp.maximum(slots, 0)
    eidx2 = earange[:, None]
    safe_act = tree.cand_act[eidx2, lps, safe_slot].astype(jnp.int32)

    parent_state = EnvState(
        board=tree.node_board[eidx2, lps],
        to_play=tree.node_to_play[eidx2, lps],
        last_move=tree.node_last[eidx2, lps],
        move_count=tree.node_count[eidx2, lps],
        done=tree.node_done[eidx2, lps],
        winner=tree.node_winner[eidx2, lps],
    )
    flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
    unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
    stepped = jax.tree.map(unflat, vector.step(
        env_cfg, jax.tree.map(flat, parent_state), flat(safe_act)))

    def sel_(a_, b_):
        m = is_revisit.reshape(is_revisit.shape + (1,) * (a_.ndim - 2))
        return jnp.where(m, a_, b_)

    leaf_state = jax.tree.map(sel_, parent_state, stepped)

    edge_key = lps * c + safe_slot
    expanding = ~is_revisit
    same = ((edge_key[:, :, None] == edge_key[:, None, :])
            & expanding[:, :, None] & expanding[:, None, :])
    jj = jnp.arange(lb, dtype=jnp.int32)
    first_lane = jnp.where(same, jj[None, None, :], lb).min(-1)
    link_id = base + first_lane
    is_first = expanding & (first_lane == jj[None, :])
    link_add = jnp.where(is_first, link_id + 1, 0).astype(jnp.int16)

    # ONE batched evaluation per pass
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
    slot_p, slot_act = _top_c(
        jnp.where(child_legal, child_p, -1.0), c, prior_dtype)

    upd = lambda arr, u: jax.lax.dynamic_update_slice_in_dim(
        arr, u, base, axis=1)
    tree = tree.replace(
        node_board=upd(tree.node_board, stepped.board),
        node_to_play=upd(tree.node_to_play, stepped.to_play),
        node_last=upd(tree.node_last, stepped.last_move),
        node_count=upd(tree.node_count, stepped.move_count),
        node_done=upd(tree.node_done, stepped.done),
        node_winner=upd(tree.node_winner, stepped.winner),
        p=upd(tree.p, slot_p),
        cand_act=upd(tree.cand_act, slot_act),
        child=tree.child.at[eidx2, lps, safe_slot].add(link_add),
    )

    dn = jnp.arange(d)[None, None, :]
    on_path = dn < deps[:, :, None]
    exp_ = (deps[:, :, None] - dn).astype(jnp.int32)
    sign = jnp.where(exp_ % 2 == 0, 1.0, -1.0)
    vals = jnp.where(on_path, sign * leaf_value[:, :, None], 0.0)
    eidx3 = earange[:, None, None]
    if packed:
        pw = jnp.round(vals * w_scale).astype(jnp.int32)  # [E,lb,D] units
        if defer:
            # hand this pass's results to the next one instead of
            # scattering (mask invalid tail entries so the next select's
            # lookup reads clean zeros beyond deps)
            return tree, key, (jnp.where(on_path, ppas, 0), pw, deps)
        # one combined (value << 16) + visit scatter per pass — for both
        # this pass and (deferred mode) the previous one, concatenated
        # along the lane axis into a single scatter
        delta = (pw << 16) + on_path.astype(jnp.int32)
        if pending is not None:
            p_ppas, p_pw, p_deps = pending
            p_on = jnp.arange(d)[None, None, :] < p_deps[:, :, None]
            p_delta = (p_pw << 16) + p_on.astype(jnp.int32)
            pns = jnp.concatenate([pns, p_ppas >> 8], axis=1)
            pas = jnp.concatenate([pas, p_ppas & 255], axis=1)
            delta = jnp.concatenate([delta, p_delta], axis=1)
        tree = tree.replace(n=tree.n.at[eidx3, pns, pas].add(delta))
    else:
        assert pending is None and not defer
        if fixed_w:
            vals = jnp.round(vals * w_scale).astype(jnp.int16)
        tree = tree.replace(
            n=tree.n.at[eidx3, pns, pas].add(on_path.astype(jnp.uint16)),
            w=tree.w.at[eidx3, pns, pas].add(vals))
    return tree, key, None


def run_mcts_capped(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Evaluator,
    state: EnvState,
    key: jax.Array,
    *,
    num_simulations: Optional[int] = None,
    add_noise: bool = True,
) -> SearchResult:
    """Branch-capped search; same contract as search.run_mcts."""
    sims = int(num_simulations or mcts_cfg.num_simulations)
    e, a = state.board.shape
    c = min(int(mcts_cfg.branch_cap), a)
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (jnp.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else jnp.float32)
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    value_dtype = jnp.int16 if fixed_w else jnp.float32
    w_scale = 64.0 if fixed_w else 1.0
    c_puct = jnp.float32(mcts_cfg.c_puct)
    forced_k = jnp.float32(mcts_cfg.forced_playouts_k if add_noise else 0.0)
    assert nn <= 32767
    # path entries pack (node << 8 | slot): slot ids must fit in 8 bits,
    # or backup scatters corrupt silently (round-2 advisor finding)
    assert c <= 256, "branch_cap must be <= 256 (path packs slot in 8 bits)"

    key, knoise, keval = jax.random.split(key, 3)

    # Production int16 mode packs (visit count | fixed-point value sum)
    # into ONE s32 array: one row gather per select step and one backup
    # scatter per pass instead of two each (the backup scatters were the
    # largest non-matmul ops in the pass profile). n increments (+1, low
    # 16 bits) never carry into the value field (n <= 511); value adds are
    # plain two's-complement adds shifted left 16.
    packed = fixed_w
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
    root_logits, _ = evaluate(state.board, state.to_play, state.last_move,
                              keval)
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)
    if add_noise:
        noise = dirichlet_noise(knoise, mcts_cfg.dirichlet_alpha, root_legal)
        eps = jnp.float32(mcts_cfg.dirichlet_eps)
        root_p = (1.0 - eps) * root_p + eps * noise
    root_slot_p, root_slot_act = _top_c(
        jnp.where(root_legal, root_p, -1.0), c, prior_dtype, exact=True)
    tree = tree.replace(
        p=tree.p.at[:, 0].set(root_slot_p),
        cand_act=tree.cand_act.at[:, 0].set(root_slot_act))

    earange = jnp.arange(e)
    lb = max(1, int(mcts_cfg.leaf_batch))
    while sims % lb:
        lb -= 1
    passes = sims // lb
    d = depth_limit

    def pass_(tree, key, p_, d, pending=None, defer=False):
        return _run_pass(
            env_cfg, evaluate, tree, key, base=1 + p_ * lb, d=d,
            lb=lb, c=c, packed=packed, fixed_w=fixed_w,
            w_scale=w_scale, prior_dtype=prior_dtype, c_puct=c_puct,
            forced_k=forced_k, pending=pending, defer=defer)

    def make_pass_body(d):
        # `d` is the static path-depth cap for ONE stage of passes (see
        # the staged loop below); the body itself is the shared _run_pass
        def pass_body(p_, carry):
            tree, key = carry
            tree, key, _ = pass_(tree, key, p_, d)
            return tree, key
        return pass_body

    def make_pair_body(d):
        # deferred backup (mcts_cfg.backup_interval=2, packed mode):
        # pass 2q skips its scatter and hands its results to pass 2q+1
        # through the PUCT-exact pending lookup (_select_lanes); pass
        # 2q+1 materializes both in ONE scatter. Bit-identical search,
        # half the [E,NN,C] scatter traffic.
        def pair_body(q, carry):
            tree, key = carry
            tree, key, pend = pass_(tree, key, 2 * q, d, defer=True)
            tree, key, _ = pass_(tree, key, 2 * q + 1, d, pending=pend)
            return tree, key
        return pair_body

    defer_ok = packed and int(getattr(mcts_cfg, "backup_interval", 1)) >= 2

    def run_stage(tree, key, lo, hi, d):
        if not defer_ok:
            return jax.lax.fori_loop(lo, hi, make_pass_body(d),
                                     (tree, key))
        # pairs must align on even pass indices so resumed stages keep
        # the same pairing; odd-index boundaries run single passes
        if lo % 2 and lo < hi:
            tree, key, _ = pass_(tree, key, lo, d)
            lo += 1
        tree, key = jax.lax.fori_loop(lo // 2, hi // 2, make_pair_body(d),
                                      (tree, key))
        if hi % 2 and lo <= hi - 1:
            tree, key, _ = pass_(tree, key, hi - 1, d)
        return tree, key

    # DEPTH-STAGED pass loops: the tree deepens by at most one level per
    # pass (links are committed only at pass end), so a descent in pass p
    # can record at most p + 1 edges. Early passes therefore run with a
    # much smaller static path-depth cap — the backup scatter's index
    # count, the path buffers, and the virtual-visit lookup all scale
    # with that cap, and the round-3 profile showed the backup scatter
    # (padded to max_depth, ~88% zero-delta indices at typical depths)
    # was the single largest non-matmul op of the pass where this was
    # first tuned. Stages double the cap from 8 up to min(max_depth,
    # passes); semantics are identical because the tighter caps are
    # unreachable by construction.
    lo = 0
    dc = 8
    while lo < passes:
        if dc >= min(d, passes):
            tree, key = run_stage(tree, key, lo, passes, min(d, passes))
            break
        tree, key = run_stage(tree, key, lo, min(passes, dc), dc)
        lo = min(passes, dc)
        dc *= 2

    # scatter slot visit counts back onto the action space
    if packed:
        n0 = (tree.n[:, 0, :] & 0xFFFF).astype(jnp.float32)     # [E, C]
        w_root = (tree.n[:, 0, :] >> 16).astype(jnp.float32).sum(-1) / w_scale
    else:
        n0 = tree.n[:, 0, :].astype(jnp.float32)                # [E, C]
        w_root = tree.w[:, 0, :].astype(jnp.float32).sum(-1) / w_scale
    act0 = tree.cand_act[:, 0, :].astype(jnp.int32)     # [E, C]
    visits = jnp.zeros((e, a), jnp.float32).at[
        earange[:, None], act0].add(n0)                 # pads add 0
    n_sum = n0.sum(-1)
    root_value = jnp.where(n_sum > 0, w_root / jnp.maximum(n_sum, 1.0), 0.0)
    return SearchResult(visits=visits, root_value=root_value, priors=root_p)
