"""Faithful sequential reference implementations (numpy/python), a copy of
``repro/core/sssp/reference.py`` for the port.

These follow the paper's pseudocode structurally — including the worklists
R and Q, the deferred heap insertions, pred counting, inWeight (excluding
the discovering vertex, per SP2 Step 1), the second heap G of SP3, and
virtual heap deletions — so that the *heap-operation counts* and *round
counts* reported by the benchmark harness are the paper's quantities, not
an approximation.

All four return a :class:`RefResult` with float64 distances and a stats
dict: heap op counts, outer-loop rounds, peak |R| (available parallelism),
and edges relaxed.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.graph import HostGraph

INF = float("inf")


class IndexedHeap:
    """Binary min-heap with decrease-key via a position map + op counters.

    ``removeMin``/``getMin`` lazily skip vertices whose entry has been
    *virtually* deleted (SP3 marks vertices fixed without a physical heap
    delete — "deletion from the heap is only a virtual operation").
    """

    def __init__(self, counters: dict):
        self.keys: dict[int, float] = {}
        self.arr: list[int] = []
        self.pos: dict[int, int] = {}
        self.dead: set[int] = set()
        self.live = 0
        self.c = counters

    def __len__(self):
        return len(self.arr)

    def _swap(self, i, j):
        a = self.arr
        a[i], a[j] = a[j], a[i]
        self.pos[a[i]] = i
        self.pos[a[j]] = j

    def _up(self, i):
        while i > 0:
            p = (i - 1) // 2
            if self.keys[self.arr[i]] < self.keys[self.arr[p]]:
                self._swap(i, p)
                i = p
            else:
                break

    def _down(self, i):
        n = len(self.arr)
        while True:
            l, r, m = 2 * i + 1, 2 * i + 2, i
            if l < n and self.keys[self.arr[l]] < self.keys[self.arr[m]]:
                m = l
            if r < n and self.keys[self.arr[r]] < self.keys[self.arr[m]]:
                m = r
            if m == i:
                return
            self._swap(i, m)
            i = m

    def insert(self, v: int, key: float):
        self.c["insert"] += 1
        self.keys[v] = key
        self.arr.append(v)
        self.pos[v] = len(self.arr) - 1
        self.dead.discard(v)
        self.live += 1
        self._up(len(self.arr) - 1)

    def insert_or_adjust(self, v: int, key: float):
        if v in self.pos:
            if key < self.keys[v]:
                self.c["adjust"] += 1
                self.keys[v] = key
                self._up(self.pos[v])
        else:
            self.insert(v, key)

    def virtual_remove(self, v: int):
        if v in self.pos and v not in self.dead:
            self.dead.add(v)
            self.live -= 1

    def _pop_root(self) -> tuple[int, float]:
        v = self.arr[0]
        k = self.keys[v]
        last = self.arr.pop()
        del self.pos[v]
        if self.arr:
            self.arr[0] = last
            self.pos[last] = 0
            self._down(0)
        del self.keys[v]
        if v in self.dead:
            self.dead.discard(v)
        else:
            self.live -= 1
        return v, k

    def remove_min(self):
        """Physically pop the min *live* vertex; pops of dead (virtually
        removed) entries are counted — they are real heap work — but
        skipped, per SP3's lazy-deletion semantics."""
        while self.arr:
            self.c["removemin"] += 1
            v, k = self._pop_root()
            if v in self.dead:
                continue
            return v, k
        return None, INF

    def get_min_key(self) -> float:
        while self.arr and self.arr[0] in self.dead:
            self.c["removemin"] += 1
            self._pop_root()
        if not self.arr:
            return INF
        return self.keys[self.arr[0]]

    def empty_live(self) -> bool:
        """True iff no live (non-dead) vertex remains.

        The paper overloads H.empty() to consult a count of non-fixed
        vertices; we keep an equivalent O(1) live count."""
        return self.live == 0


def _new_counters():
    return {"insert": 0, "adjust": 0, "removemin": 0}


@dataclasses.dataclass
class RefResult:
    dist: np.ndarray
    stats: dict

    @property
    def heap_ops(self) -> int:
        return sum(v for k, v in self.stats.items()
                   if k.startswith(("h_", "g_")))


# ---------------------------------------------------------------------------
# Dijkstra (Fig. 1)
# ---------------------------------------------------------------------------

def dijkstra(g: HostGraph, source: int = 0) -> RefResult:
    n = g.n
    D = np.full(n, INF)
    fixed = np.zeros(n, bool)
    c = _new_counters()
    H = IndexedHeap(c)
    D[source] = 0.0
    H.insert(source, 0.0)
    edges_relaxed = 0
    rounds = 0
    while len(H):
        j, d = H.remove_min()
        if j is None:
            break
        rounds += 1
        fixed[j] = True
        for k, w in g.out[j]:
            if fixed[k]:
                continue
            edges_relaxed += 1
            if D[k] > D[j] + w:
                D[k] = D[j] + w
                H.insert_or_adjust(k, D[k])
    stats = {"h_" + k: v for k, v in c.items()}
    stats.update(rounds=rounds, edges_relaxed=edges_relaxed, max_frontier=1)
    return RefResult(D, stats)


# ---------------------------------------------------------------------------
# SP1 (Fig. 3) — predecessor counting
# ---------------------------------------------------------------------------

def _prune_pred(g: HostGraph, source: int, pred: np.ndarray):
    """The paper's L-procedure: iteratively discount in-edges from vertices
    (≠ source) that have zero in-degree — they are unreachable."""
    L = deque(v for v in range(g.n) if v != source and pred[v] == 0)
    removed = np.zeros(g.n, bool)
    while L:
        v = L.popleft()
        if removed[v]:
            continue
        removed[v] = True
        for k, _ in g.out[v]:
            pred[k] -= 1
            if pred[k] == 0 and k != source and not removed[k]:
                L.append(k)


def _sp12_core(g: HostGraph, source: int, use_inweight: bool) -> RefResult:
    n = g.n
    D = np.full(n, INF)
    fixed = np.zeros(n, bool)
    pred = np.array([len(g.inn[v]) for v in range(n)], np.int64)
    _prune_pred(g, source, pred)
    inweight = np.full(n, INF)
    c = _new_counters()
    H = IndexedHeap(c)
    Q: list[int] = []
    in_q = np.zeros(n, bool)
    R: deque[int] = deque()
    D[source] = 0.0
    H.insert(source, 0.0)
    rounds = 0
    edges_relaxed = 0
    max_frontier = 0
    d_cur = 0.0

    def explore(z: int):
        nonlocal edges_relaxed
        for k, w in g.out[z]:
            if fixed[k]:
                continue
            edges_relaxed += 1
            pred[k] -= 1
            changed = False
            if use_inweight and D[k] == INF and pred[k] > 0:
                inweight[k] = min(
                    (ww for (v, ww) in g.inn[k] if v != z), default=INF)
            if D[k] > D[z] + w:
                D[k] = D[z] + w
                changed = True
            can_fix = pred[k] == 0
            if use_inweight and not can_fix:
                can_fix = D[k] <= d_cur + inweight[k]
            if can_fix:
                fixed[k] = True
                H.virtual_remove(k)  # Fig. 3: fixing removes it effectively
                R.append(k)
            elif changed and not in_q[k]:
                Q.append(k)
                in_q[k] = True

    while not H.empty_live():
        j, d = H.remove_min()
        if j is None:
            break
        if fixed[j]:
            continue  # explored fixed vertices may linger in H (Fig. 3)
        rounds += 1
        d_cur = d
        fixed[j] = True
        R.append(j)
        while R:
            max_frontier = max(max_frontier, len(R))
            z = R.popleft()
            explore(z)
        for z in Q:
            in_q[z] = False
            if not fixed[z]:
                H.insert_or_adjust(z, D[z])
        Q.clear()
    stats = {"h_" + k: v for k, v in c.items()}
    stats.update(rounds=rounds, edges_relaxed=edges_relaxed,
                 max_frontier=max_frontier)
    return RefResult(D, stats)


def sp1(g: HostGraph, source: int = 0) -> RefResult:
    return _sp12_core(g, source, use_inweight=False)


def sp2(g: HostGraph, source: int = 0) -> RefResult:
    return _sp12_core(g, source, use_inweight=True)


# ---------------------------------------------------------------------------
# SP3 (Fig. 5) — lower bounds C + threshold heap G
# ---------------------------------------------------------------------------

def sp3(g: HostGraph, source: int = 0) -> RefResult:
    n = g.n
    D = np.full(n, INF)
    C = np.zeros(n)
    fixed = np.zeros(n, bool)
    out_weight = np.array(
        [min((w for _, w in g.out[v]), default=INF) for v in range(n)])
    ch = _new_counters()
    cg = _new_counters()
    H = IndexedHeap(ch)
    G = IndexedHeap(cg)
    Q: list[int] = []
    in_q = np.zeros(n, bool)
    R: deque[int] = deque()
    D[source] = 0.0
    H.insert(source, 0.0)
    G.insert(source, 0.0 + out_weight[source])
    rounds = 0
    edges_relaxed = 0
    max_frontier = 0

    # NOTE on faithfulness: Fig. 5's processEdge3 reads H.getMin() *live*
    # during R-processing, but heap updates are deferred in Q, so the live
    # heap min can exceed the true frontier minimum (stale keys; newly
    # discovered vertices absent) — following the pseudocode literally
    # produced premature fixes and wrong distances on random graphs.  We
    # use the sound phase-start bound
    #   B = min( H.getMin()  [keys are current here: Q was flushed],
    #            min_{u in R, unexplored} D[u] + outWeight[u] )
    # which lower-bounds cost[x] of every vertex non-fixed at phase start
    # (cut argument over fixed->non-fixed edges, explored and not), and
    # remains sound for the whole phase because the non-fixed set only
    # shrinks.  Documented in DESIGN.md §Paper-faithfulness.
    B_phase = INF

    def process_edge3(z: int, k: int, w: float):
        nonlocal edges_relaxed
        edges_relaxed += 1
        changed = False
        # step 1: relax
        if D[k] > D[z] + w:
            D[k] = D[z] + w
            changed = True
        # step 2: lift C of non-fixed predecessors to the frontier bound
        for v, _ in g.inn[k]:
            if not fixed[v]:
                C[v] = max(C[v], B_phase)
        # step 3: Eqn (1)
        cand = min((C[v] + wv for (v, wv) in g.inn[k]), default=INF)
        C[k] = max(C[k], cand)
        # step 4: fix?
        if C[k] == D[k]:
            fixed[k] = True
            R.append(k)
            G.virtual_remove(k)
            H.virtual_remove(k)
        elif changed and not in_q[k]:
            Q.append(k)
            in_q[k] = True

    while not H.empty_live():
        rounds += 1
        threshold = G.get_min_key()
        while H.get_min_key() <= threshold:
            j, d = H.remove_min()
            if j is None:
                break
            if fixed[j]:
                continue
            G.virtual_remove(j)
            fixed[j] = True
            C[j] = D[j]
            R.append(j)
            if H.empty_live():
                break
        B_phase = min(
            H.get_min_key(),
            min((D[u] + out_weight[u] for u in R), default=INF))
        while R:
            max_frontier = max(max_frontier, len(R))
            z = R.popleft()
            for k, w in g.out[z]:
                if not fixed[k]:
                    process_edge3(z, k, w)
        for z in Q:
            in_q[z] = False
            if not fixed[z]:
                H.insert_or_adjust(z, D[z])
                G.insert_or_adjust(z, D[z] + out_weight[z])
        Q.clear()
    stats = {"h_" + k: v for k, v in ch.items()}
    stats.update({"g_" + k: v for k, v in cg.items()})
    stats.update(rounds=rounds, edges_relaxed=edges_relaxed,
                 max_frontier=max_frontier)
    return RefResult(D, stats)
