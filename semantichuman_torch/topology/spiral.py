"""Spiral-ordering enumeration for spiral mesh convolutions (the port's
copy of `semantichuman_tpu/topology/spiral.py`, held to it index for index
by tests/test_torch_topology.py).

For every vertex, enumerates its k-ring neighborhood as a deterministic,
counter-clockwise "spiral": start the first ring at a well-defined neighbor
(the Dijkstra predecessor toward a per-level reference vertex), walk the
triangle fan, handle boundaries by walking the other direction in reverse
insertion order with a -1 pad between the halves, then induct outward ring
by ring.  This reproduces the algorithm of the reference generator
(utils_spiral.py:45-417) — which in turn defines the layout of every conv
weight matrix — and is PROVEN index-for-index equal to it by oracle
fixtures: tools/gen_spiral_oracle.py runs the reference's own generator on
our hierarchies (small + production-scale SMPL-shaped templates → committed
as tests/golden/spiral_oracle_{small,full}.npz, asserted by
tests/test_topology.py), and tools/stress_spiral_oracle.py additionally
matches it on boundary grids, 3-ring walks, multi-reference-point
accumulation, and 12 random vertex relabelings (which scramble Python's
set-hash iteration order).

Implementation notes vs the reference text (all proven outcome-equivalent
by the oracles above):

  * triangle pools are insertion-ordered (dict-backed) instead of Python
    sets; on 2-manifold-with-boundary meshes every candidate choice the
    walk makes is forced or orientation-disambiguated, so pool order does
    not change the output (verified across hash-order-scrambling
    relabelings);
  * Dijkstra edge weights use the reference's exact sqrt(sum(square))
    formula — np.linalg.norm differs in the last ulp, and near-ties decide
    the predecessor that anchors each spiral;
  * multi-source Dijkstra accumulation keeps the reference quirk that a
    later source's tree fully overwrites earlier ones;
  * the first-ring walk's redundant `p != v` filter (always implied by
    `p not in seen`) is dropped;
  * per-ring orientation defaults to clockwise-reversed when a ring's walk
    terminates before orientation can be established (the reference reads a
    stale value from the previous ring in that corner case — not reachable
    on any oracle mesh).

Output contract matches the reference: per-level dense int table
[V+1, spiral_size] where entry -1 addresses the dummy (zero) vertex row.
"""

from __future__ import annotations

import heapq

import numpy as np


def dijkstra(verts: np.ndarray, adj: list[np.ndarray], source: int):
    """Single-source shortest path with Euclidean edge weights.

    Returns (prev, dist) lists; prev[source] is None.
    (reference: utils_spiral.py:104-125)
    """
    n = len(verts)
    dist = [None] * n
    prev = [None] * n
    q: list[tuple[float, int, int | None]] = [(0.0, source, None)]
    seen: set[int] = set()
    while q and len(seen) < n:
        d, v, p = heapq.heappop(q)
        if v in seen:
            continue
        seen.add(v)
        prev[v] = p
        dist[v] = d
        for w in adj[v]:
            w = int(w)
            if w in seen:
                continue
            # exact reference edge weight (utils_spiral.py:101-102):
            # np.linalg.norm is NOT bitwise-identical to sqrt(sum(square))
            # (last-ulp differences), and near-ties in path length decide the
            # predecessor that anchors every spiral — so match it bitwise.
            ew = float(np.sqrt(np.sum(np.square(verts[v] - verts[w]))))
            heapq.heappush(q, (d + ew, w, v))
    return prev, dist


class _TrianglePool:
    """Insertion-ordered set of triangles with incidence-filtered candidate
    queries. Mirrors the reference's `trig_central` list / `next_trigs` set
    but with deterministic ordering."""

    def __init__(self, trigs=()):
        self._d: dict[tuple, None] = dict.fromkeys(trigs)

    def __len__(self):
        return len(self._d)

    def __contains__(self, t):
        return t in self._d

    def add(self, t):
        self._d.setdefault(t, None)

    def remove(self, t):
        del self._d[t]

    def candidates(self, v: int) -> list[tuple]:
        return [t for t in self._d if v in t]

    def intersects(self, trigs) -> bool:
        return any(t in self._d for t in trigs)


def _third_vertex(tri: tuple, exclude_a: int, exclude_b: int) -> int:
    for p in tri:
        if p != exclude_a and p != exclude_b:
            return p
    raise ValueError(f"degenerate triangle {tri}")


def _walk_forward(pool: _TrianglePool, ring: list[int], seen: set,
                  center: int | None, counter_clockwise: bool):
    """Forward (counter-clockwise) fan walk shared by first and outer rings.

    `center` is the spiral's central vertex for the first ring; None for
    outer rings, where "inner" membership means `in seen`.  Mutates
    ring/seen/pool; returns orientation_0 (bool) or None if never
    established (walk terminated before a second ring vertex existed).
    """
    def is_inner(p):
        return p == center if center is not None else p in seen

    orientation_0 = None
    while len(pool) > 0:
        cur_v = ring[-1]
        cand = pool.candidates(cur_v)
        if not cand:
            break
        if len(ring) == 1:
            t = cand[0]
            orientation_0 = ((is_inner(t[0]) and t[1] == cur_v)
                             or (is_inner(t[1]) and t[2] == cur_v)
                             or (is_inner(t[2]) and t[0] == cur_v))
            if not counter_clockwise:
                orientation_0 = not orientation_0
            if len(cand) >= 2:
                chosen = cand[0] if orientation_0 else cand[1]
                if center is not None:
                    third = _third_vertex(chosen, center, cur_v)
                else:
                    third = next(p for p in chosen
                                 if p not in seen and p != cur_v)
                pool.remove(chosen)
                ring.append(third)
                seen.add(third)
            else:
                break  # boundary hit at the very first step
        elif center is not None:
            # first ring: the triangle's remaining vertex is unique; skip it
            # if already visited (fan closed) but keep consuming triangles
            t = cand[0]
            third = _third_vertex(t, center, cur_v)
            pool.remove(t)
            if third not in seen:
                ring.append(third)
                seen.add(third)
        else:
            # outer rings: stop once the candidate triangle brings nothing new
            t = cand[0]
            thirds = [p for p in t if p not in seen]
            pool.remove(t)
            if thirds:
                ring.append(thirds[0])
                seen.add(thirds[0])
            else:
                break
    return orientation_0


def _walk_reverse(pool: _TrianglePool, ring: list[int], seen: set,
                  center: int | None, start_v: int, reverse_order: bool):
    """Boundary second-half walk: from the ring start in the other direction,
    inserting vertices at a fixed point so they appear in reverse order.
    Returns True if the ring needs a -1 pad between the halves."""
    rev_i = len(ring)
    v = start_v
    need_padding = False
    while len(pool) > 0:
        cand = pool.candidates(v)
        if len(cand) != 1:
            break
        need_padding = True
        t = cand[0]
        pool.remove(t)
        if center is not None:
            third = _third_vertex(t, v, center)
            if third not in seen:
                ring.insert(rev_i, third)
                seen.add(third)
                if not reverse_order:
                    rev_i = len(ring)
                v = third
        else:
            thirds = [p for p in t if p != v and p not in seen]
            if thirds:
                third = thirds[0]
                ring.insert(rev_i, third)
                seen.add(third)
                if not reverse_order:
                    rev_i = len(ring)
                v = third
    if need_padding:
        ring.insert(rev_i, -1)
    return need_padding


def get_spirals(verts: np.ndarray, adj: list[np.ndarray],
                trigs: list[list[tuple]], reference_points,
                n_steps: int = 1, counter_clockwise: bool = True):
    """Enumerate a spiral ordering (list of vertex ids, -1 = pad) per vertex."""
    reference_points = list(reference_points)
    heat_prev = None
    heat_dist = None
    for rp in reference_points:
        heat_prev, heat_dist = _dijkstra_accum(verts, adj, rp, heat_dist, heat_prev)

    spirals: list[list[int]] = []
    for i in range(len(verts)):
        seen = {i}
        pool = _TrianglePool(trigs[i])
        spiral = [i]

        # --- choose the spiral's starting neighbor -------------------------
        if i in reference_points:
            neigh = list(map(int, adj[i]))
            if neigh:
                d = [float(np.sum((verts[i] - verts[w]) ** 2)) for w in neigh]
                init_vert = neigh[int(np.argmin(d))]
            else:
                init_vert = None
        else:
            init_vert = heat_prev[i]

        # --- first ring -----------------------------------------------------
        ring: list[int] = []
        orientation_0 = None
        if init_vert is not None:
            ring = [init_vert]
            seen.add(init_vert)

            orientation_0 = _walk_forward(pool, ring, seen, center=i,
                                          counter_clockwise=counter_clockwise)
            reverse_order = not (orientation_0 and len(ring) == 1)
            _walk_reverse(pool, ring, seen, center=i, start_v=init_vert,
                          reverse_order=reverse_order)
        spiral += ring

        # --- outer rings ----------------------------------------------------
        for _step in range(n_steps - 1):
            if len(ring) == 0:
                break
            next_ring: dict[int, None] = {}
            for w in ring:
                if w == -1:
                    continue
                for u in adj[w]:
                    u = int(u)
                    if u not in seen:
                        next_ring.setdefault(u, None)

            next_pool = _TrianglePool()
            base_triangle = None
            for u in next_ring:
                for tr in trigs[u]:
                    n_seen = sum(1 for x in tr if x in seen)
                    if n_seen == 1:
                        next_pool.add(tr)
                    elif ring[0] in tr and ring[-1] in tr:
                        base_triangle = tr

            init_vert = None
            if base_triangle is not None:
                cands = [x for x in base_triangle
                         if x != ring[0] and x != ring[-1]]
                if cands and next_pool.intersects(trigs[cands[0]]):
                    init_vert = cands[0]
            if init_vert is None:
                # fall back: third vertex of a triangle joining consecutive
                # ring members, provided it can seed the next ring's walk
                for r in range(len(ring) - 1):
                    if ring[r] == -1 or ring[r + 1] == -1:
                        continue
                    shared = [t for t in trigs[ring[r]] if t in set(trigs[ring[r + 1]])]
                    found = None
                    for t in shared:
                        unseen = [p for p in t if p not in seen]
                        if unseen and next_pool.intersects(trigs[unseen[0]]):
                            found = unseen[0]
                            break
                    if found is not None:
                        init_vert = found
                        break

            if init_vert is None:
                ring = []
                break_outer = True
            else:
                ring = [init_vert]
                seen.add(init_vert)
                break_outer = False

            if not break_outer:
                orientation_0 = _walk_forward(next_pool, ring, seen, center=None,
                                              counter_clockwise=counter_clockwise)
                reverse_order = not (orientation_0 and len(ring) == 1)
                _walk_reverse(next_pool, ring, seen, center=None,
                              start_v=init_vert, reverse_order=reverse_order)
            spiral += ring

        spirals.append(spiral)
    return spirals


def _dijkstra_accum(verts, adj, source, dist, prev):
    """Reference-exact multi-source accumulation (utils_spiral.py:104-125,
    134-137): each later source's full Dijkstra tree OVERWRITES the previous
    one wherever it reaches (the reference re-runs with shared dist/prev
    lists and assigns unconditionally on pop), so on a connected mesh the
    LAST reference point wins outright.  Production uses a single anchor per
    level, but keep the quirk for exact table parity."""
    new_prev, new_dist = dijkstra(verts, adj, source)
    if dist is None:
        return new_prev, new_dist
    for v in range(len(verts)):
        if new_dist[v] is not None:
            dist[v] = new_dist[v]
            prev[v] = new_prev[v]
    return prev, dist


def generate_spirals(step_sizes, level_verts, level_adj, level_trigs,
                     reference_points, dilation=None, counter_clockwise=True,
                     nb_stds: float = 2.0):
    """Per level: spiral lists → dilation subsample → pad/truncate to a dense
    int32 table [V+1, S] (-1 pads address the dummy row).

    spiral_size per level = int(mean + nb_stds * std) of spiral lengths
    (reference: utils_spiral.py:70-82).
    Returns (tables: list[np.ndarray], spiral_sizes: list[int], raw spirals).
    """
    all_spirals = []
    for lvl in range(len(level_verts)):
        sp = get_spirals(level_verts[lvl], level_adj[lvl], level_trigs[lvl],
                         reference_points[lvl], n_steps=step_sizes[lvl],
                         counter_clockwise=counter_clockwise)
        all_spirals.append(sp)

    if dilation:
        for lvl, dil in enumerate(dilation):
            all_spirals[lvl] = [s[:1] + s[1::dil] for s in all_spirals[lvl]]

    tables = []
    spiral_sizes = []
    for lvl, spirals in enumerate(all_spirals):
        lengths = np.array([len(s) for s in spirals])
        size = int(lengths.mean() + nb_stds * lengths.std())
        spiral_sizes.append(size)
        table = np.full((len(spirals) + 1, size), -1, dtype=np.int32)
        for j, s in enumerate(spirals):
            s = s[:size]
            table[j, :len(s)] = s
        tables.append(table)
    return tables, spiral_sizes, all_spirals
