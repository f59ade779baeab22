"""BVH: host-side binned-SAH build + device stack traversal.

The replacement for OptiX GAS/IAS hardware acceleration structures
(OptixRender.cpp:218-496). Design decisions (vs a literal port):

  * SINGLE-LEVEL BVH over the world-space flattened triangle soup (instances
    baked at build, render/device_scene.py) instead of two-level GAS+IAS —
    a second indirection level doubles gather latency for no win at the
    scene sizes Strelka targets; instance semantics live host-side.
  * Triangles are REORDERED into leaf-contiguous order at build so a leaf is
    a (start, count) range — no per-primitive indirection on device.
  * Build is binned SAH (16 bins, leaf <= MAX_LEAF tris) on the host: the
    analog of optixAccelBuild with compaction; a native C++ builder
    (strelka_tpu/native) accelerates it with the same node format.
  * Traversal is a vectorized lockstep stack walk (lax.while_loop over the
    whole wavefront, per-ray stacks [N, DEPTH] as array state). Every
    iteration pops one node per ray: internal nodes test the two child AABBs
    (slab test) and push hits near-first; leaves test <= MAX_LEAF triangles
    with an unrolled Moller-Trumbore. Inactive lanes no-op — masked SIMD is
    the wavefront analog of SIMT divergence.

Node layout (SoA, [num_nodes]):
  bb_min, bb_max: [n,3] f32 — node bounds
  left, right:    [n]  i32 — child node ids (internal nodes)
  start, count:   [n]  i32 — leaf triangle range; count==0 -> internal
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_LEAF = 4
STACK_DEPTH = 48
_BIG = jnp.float32(1e16)


class BvhNodes(NamedTuple):
    bb_min: jnp.ndarray  # [n,3]
    bb_max: jnp.ndarray  # [n,3]
    left: jnp.ndarray  # [n] i32
    right: jnp.ndarray  # [n] i32
    start: jnp.ndarray  # [n] i32
    count: jnp.ndarray  # [n] i32 (0 = internal)


class ThreadedBvh(NamedTuple):
    """Stackless (threaded/skip-link) BVH in DFS order.

    Traversal state per ray is ONE int32 node index: entering node i
    continues at i+1 (DFS first child); skipping (AABB miss) or finishing a
    leaf jumps to skip[i]. skip[last] == n (the termination sentinel).
    This removes the per-ray stack (and its scatter traffic) entirely —
    the idiomatic XLA formulation: per-step work is a handful of [N]
    gathers + elementwise math; the hard step bound makes the loop immune
    to malformed trees (a clamped out-of-bounds stack write in a stacked
    traversal can otherwise spin forever).

    bb_min/bb_max: [n,3]; skip: [n] i32; start/count: [n] i32 (count==0
    internal). Leaf triangle ranges index the reordered triangle arrays.
    """

    bb_min: jnp.ndarray
    bb_max: jnp.ndarray
    skip: jnp.ndarray
    start: jnp.ndarray
    count: jnp.ndarray


# ---------------------------------------------------------------------------
# Host build (numpy binned SAH)
# ---------------------------------------------------------------------------


def build_bvh_sah(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, max_leaf: int = MAX_LEAF
) -> Tuple[BvhNodes, np.ndarray]:
    """Build a binned-SAH BVH. Returns (nodes, permutation).

    permutation[i] = original index of the triangle at reordered slot i;
    callers must reorder ALL per-triangle arrays with it.
    """
    try:
        from strelka_tpu.native import native_build_bvh

        out = native_build_bvh(v0, e1, e2, max_leaf)
        if out is not None:
            return out
    except ImportError:
        pass
    return _build_bvh_numpy(v0, e1, e2, max_leaf)


def _build_bvh_numpy(v0, e1, e2, max_leaf):
    n = v0.shape[0]
    p0 = v0.astype(np.float64)
    p1 = p0 + e1
    p2 = p0 + e2
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(n, dtype=np.int64)
    # flat node storage grown as we go
    bb_min, bb_max, left, right, start, count = [], [], [], [], [], []

    def new_node():
        bb_min.append(np.zeros(3))
        bb_max.append(np.zeros(3))
        left.append(0)
        right.append(0)
        start.append(0)
        count.append(0)
        return len(bb_min) - 1

    NBINS = 16
    # iterative stack of (node_id, lo, hi) over `order` slices
    root = new_node()
    stack = [(root, 0, n)]
    while stack:
        node_id, lo, hi = stack.pop()
        idx = order[lo:hi]
        nb_min = tri_min[idx].min(axis=0)
        nb_max = tri_max[idx].max(axis=0)
        bb_min[node_id] = nb_min
        bb_max[node_id] = nb_max
        num = hi - lo
        if num <= max_leaf:
            start[node_id] = lo
            count[node_id] = num
            continue
        cmin = centroid[idx].min(axis=0)
        cmax = centroid[idx].max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            # degenerate spread: median split
            mid = lo + num // 2
        else:
            # binned SAH
            scale = NBINS * (1.0 - 1e-6) / ext[axis]
            bins = ((centroid[idx, axis] - cmin[axis]) * scale).astype(np.int32)
            bins = np.clip(bins, 0, NBINS - 1)
            cnt = np.bincount(bins, minlength=NBINS)
            # per-bin bounds
            binf_min = np.full((NBINS, 3), np.inf)
            binf_max = np.full((NBINS, 3), -np.inf)
            for b in range(NBINS):
                sel = bins == b
                if sel.any():
                    binf_min[b] = tri_min[idx[sel]].min(axis=0)
                    binf_max[b] = tri_max[idx[sel]].max(axis=0)
            # sweep areas
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = num - lcnt
            lmin = np.minimum.accumulate(binf_min, axis=0)[:-1]
            lmax = np.maximum.accumulate(binf_max, axis=0)[:-1]
            rmin = np.minimum.accumulate(binf_min[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(binf_max[::-1], axis=0)[::-1][1:]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax) * lcnt + area(rmin, rmax) * rcnt
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = lo + num // 2
            else:
                sel_left = bins <= best
                # partition order[lo:hi]
                order[lo:hi] = np.concatenate([idx[sel_left], idx[~sel_left]])
                mid = lo + int(sel_left.sum())
        if mid == lo or mid == hi:
            mid = lo + num // 2
            # re-sort by centroid for median split
            idx = order[lo:hi]
            key = np.argsort(centroid[idx, axis], kind="stable")
            order[lo:hi] = idx[key]
        l_id = new_node()
        r_id = new_node()
        left[node_id] = l_id
        right[node_id] = r_id
        stack.append((r_id, mid, hi))
        stack.append((l_id, lo, mid))

    nodes = BvhNodes(
        bb_min=np.asarray(bb_min, np.float32),
        bb_max=np.asarray(bb_max, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        start=np.asarray(start, np.int32),
        count=np.asarray(count, np.int32),
    )
    return nodes, order.astype(np.int64)


def thread_bvh(nodes: BvhNodes) -> ThreadedBvh:
    """Reorder a built BVH into DFS order and compute skip links (host).

    DFS position strictly increases during traversal (enter -> i+1,
    skip/finish -> skip[i] > i), so a ray visits each node at most once and
    the step count is bounded by num_nodes.
    """
    bb_min = np.asarray(nodes.bb_min)
    bb_max = np.asarray(nodes.bb_max)
    left = np.asarray(nodes.left)
    right = np.asarray(nodes.right)
    start = np.asarray(nodes.start)
    count = np.asarray(nodes.count)
    n = len(count)

    # subtree sizes (iterative post-order)
    size = np.ones(n, np.int64)
    post = []
    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        if processed:
            if count[node] == 0:
                size[node] = 1 + size[left[node]] + size[right[node]]
            post.append(node)
            continue
        stack.append((node, True))
        if count[node] == 0:
            stack.append((int(right[node]), False))
            stack.append((int(left[node]), False))

    # DFS emit with skip targets
    new_bb_min = np.empty_like(bb_min)
    new_bb_max = np.empty_like(bb_max)
    new_skip = np.empty(n, np.int32)
    new_start = np.empty(n, np.int32)
    new_count = np.empty(n, np.int32)
    pos = 0
    stack2 = [(0, n)]  # (old node, skip target in NEW ids)
    while stack2:
        node, skip_target = stack2.pop()
        my_pos = pos
        pos += 1
        new_bb_min[my_pos] = bb_min[node]
        new_bb_max[my_pos] = bb_max[node]
        new_skip[my_pos] = skip_target
        new_start[my_pos] = start[node]
        new_count[my_pos] = count[node]
        if count[node] == 0:
            l, r = int(left[node]), int(right[node])
            right_pos = my_pos + 1 + int(size[l])
            # children visited left-first: push right (deeper in stack) first
            stack2.append((r, skip_target))
            stack2.append((l, right_pos))
    assert pos == n
    return ThreadedBvh(
        bb_min=new_bb_min.astype(np.float32),
        bb_max=new_bb_max.astype(np.float32),
        skip=new_skip,
        start=new_start,
        count=new_count,
    )


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------


def _slab_test(bb_min, bb_max, o, inv_d, tmin, tmax):
    """Ray-AABB slab test. All [N,3]/[N]; returns (hit [N] bool, tnear [N])."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tlo, axis=-1), tmin)
    tfar = jnp.minimum(jnp.min(thi, axis=-1), tmax)
    return tnear <= tfar, tnear


def _tri_test(o, d, v0, e1, e2, tmin, tmax):
    """Single-triangle Moller-Trumbore per ray. All [N,3]; -> (t, u, v, hit)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return t, u, v, hit


def intersect_bvh(
    bvh: ThreadedBvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    tri_mask: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    ray_mask: int,
    active: jnp.ndarray | None = None,
    any_hit: bool = False,
    exclude: jnp.ndarray | None = None,
    with_steps: bool = False,
):
    """Lockstep stackless traversal over the threaded BVH.

    Per-ray state is one DFS node index (+ best hit); each step is a few [N]
    gathers + elementwise math, no scatters. The step counter bounds the
    loop at num_nodes+1 (DFS position is strictly increasing), so the loop
    terminates even on malformed input. Returns (t, prim, u, v); prim indexes
    the REORDERED triangle arrays, -1 on miss. any_hit=True retires lanes on
    the first accepted hit (occlusion semantics). exclude: [N] i32 origin
    primitive id rejected exactly (same self-intersection guard as the
    brute-force sweep), -1/None = none. with_steps=True also returns the
    number of while-loop iterations the sweep took (the slowest lane's
    visited-node count).
    """
    n = origins.shape[0]
    n_nodes = bvh.skip.shape[0]
    sentinel = jnp.int32(n_nodes)
    if active is None:
        active = jnp.ones(n, bool)
    inv_d = 1.0 / jnp.where(jnp.abs(directions) > 1e-20, directions, 1e-20)

    node = jnp.where(active, 0, n_nodes).astype(jnp.int32)
    best_t = tmax * 1.0
    best_prim = jnp.full(n, -1, jnp.int32)
    best_u = jnp.zeros(n, jnp.float32)
    best_v = jnp.zeros(n, jnp.float32)
    max_steps = n_nodes + 1

    def cond(state):
        node, _bt, _bp, _bu, _bv, step = state
        return jnp.any(node < sentinel) & (step < max_steps)

    def body(state):
        node, best_t, best_prim, best_u, best_v, step = state
        lane_active = node < sentinel
        nodec = jnp.minimum(node, sentinel - 1)
        hit_box, _ = _slab_test(bvh.bb_min[nodec], bvh.bb_max[nodec], origins, inv_d, tmin, best_t)
        cnt = bvh.count[nodec]
        is_leaf = cnt > 0
        leaf_start = bvh.start[nodec]
        proc_leaf = lane_active & is_leaf & hit_box
        for k in range(MAX_LEAF):
            prim = jnp.minimum(leaf_start + k, tri_v0.shape[0] - 1)
            t, u, v, hit = _tri_test(
                origins, directions, tri_v0[prim], tri_e1[prim], tri_e2[prim], tmin, best_t
            )
            mask_ok = (tri_mask[prim] & ray_mask) != 0
            hit = hit & proc_leaf & (k < cnt) & mask_ok
            if exclude is not None:
                hit = hit & (prim != exclude)
            best_prim = jnp.where(hit, prim, best_prim)
            best_u = jnp.where(hit, u, best_u)
            best_v = jnp.where(hit, v, best_v)
            best_t = jnp.where(hit, t, best_t)
        enter = lane_active & hit_box & ~is_leaf
        nxt = jnp.where(enter, nodec + 1, bvh.skip[nodec])
        node = jnp.where(lane_active, nxt, node)
        if any_hit:
            node = jnp.where(best_prim >= 0, sentinel, node)
        return node, best_t, best_prim, best_u, best_v, step + 1

    state = (node, best_t, best_prim, best_u, best_v, jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    _, best_t, best_prim, best_u, best_v, steps = state
    best_t = jnp.where(best_prim >= 0, best_t, _BIG)
    if with_steps:
        return best_t, best_prim, best_u, best_v, steps
    return best_t, best_prim, best_u, best_v
