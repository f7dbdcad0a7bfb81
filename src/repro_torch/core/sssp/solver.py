"""The SSSP solver facade (port of ``repro/core/sssp/solver.py``).

``Solver`` does everything per-graph once — layout build (ELL, CSR) and
the move to the device — so answering a source is one engine run:

  * ``solve(s)`` runs the batch-first engine at B = 1;
  * ``solve_batch`` pads the batch to the next power of two (repeating
    the last source, as the reference does for its compiled shapes) and
    runs all lanes in one loop;
  * backends are instances of the primitives protocol (backends.py), so
    "segment", "ell"/"pallas" and "frontier" share the round body.

The solver runs on CUDA unless ``device="cpu"`` is passed; without a card
it raises rather than falling back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import (CsrGraph, EllGraph, Graph, HostGraph,
                                    build_ell, build_graph, resolve_device)
from repro_torch.core.sssp import backends
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter,
                                          _fixed_by_dict, _solve)

BACKENDS = ("auto", "segment", "ell", "pallas", "frontier")


@dataclasses.dataclass
class SSSPBatchResult:
    """Distances for B sources on one graph; indexable into SSSPResults."""

    sources: np.ndarray       # int32[B]
    dist: torch.Tensor        # float32[B, n]
    C: torch.Tensor           # float32[B, n]
    fixed: torch.Tensor       # bool[B, n]
    rounds: np.ndarray        # int32[B]
    fixed_by: list[dict[str, int]]
    graph: Graph | None = None
    edges_relaxed: np.ndarray | None = None  # int64[B] (frontier backend)
    host_syncs: int | None = None            # device->host reads of the run

    def __len__(self) -> int:
        return len(self.sources)

    def result(self, i: int) -> SSSPResult:
        return SSSPResult(
            dist=self.dist[i], C=self.C[i], fixed=self.fixed[i],
            rounds=int(self.rounds[i]), fixed_by=self.fixed_by[i],
            source=int(self.sources[i]), graph=self.graph,
            edges_relaxed=None if self.edges_relaxed is None
            else int(self.edges_relaxed[i]))

    __getitem__ = result


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _frontier_fits(g: Graph) -> bool:
    """``backend="auto"`` proxy for thin wavefronts: low average degree
    (chain, grid) or bounded out-degree (geometric), and no hub whose
    out-degree would bloat the ``cap * max_out_deg`` gather."""
    if g.e == 0:
        return False
    max_out = int(g.out_deg.max()) if g.n else 0
    return (g.e <= 4 * g.n or max_out <= 8) and max_out <= 64


def _default_frontier_cap(n: int) -> int:
    return _next_pow2(min(max(n // 4, 32), 4096))


class Solver:
    """Multi-source SSSP over one graph.

    graph:    a ``Graph`` (moved to ``device``), a ``HostGraph``, or an
              ``(n, src, dst, w)`` tuple of host arrays.
    cfg:      engine configuration (rules / label-correcting / c-prop).
    backend:  "auto" | "segment" | "ell" | "pallas" | "frontier".  "auto"
              picks "pallas" when ``cfg.use_pallas``, else "frontier" for
              thin-wavefront graphs, else "segment".  "ell" and "pallas"
              are one backend here: the ELL kernels on CUDA, their plain
              versions on the CPU.
    ell:      pre-built ``EllGraph`` for ell/pallas (else built here).
    frontier_cap: compacted-buffer size of the frontier backend (rounded
              up to a power of two; a round whose union frontier outgrows
              it runs the dense relax, bitwise the same).
    device:   where the solve runs; CUDA unless given.
    """

    def __init__(self, graph, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "auto", *, ell: EllGraph | None = None,
                 max_deg_cap: int | None = None,
                 frontier_cap: int | None = None, device=None):
        if backend == "distributed":
            raise NotImplementedError(
                "the distributed backend is not ported yet (ROADMAP A10)")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        device = resolve_device(device)
        if isinstance(graph, HostGraph):
            graph = graph.to_device(device)
        elif isinstance(graph, tuple):
            graph = build_graph(*graph, device=device)
        if not isinstance(graph, Graph):
            raise TypeError(f"graph must be Graph/HostGraph/tuple, "
                            f"got {type(graph)!r}")
        graph = graph.to(device)
        if backend == "auto":
            if cfg.use_pallas:
                backend = "pallas"
            elif _frontier_fits(graph):
                backend = "frontier"
            else:
                backend = "segment"
        # normalize cfg.use_pallas as the reference does: "pallas" forces
        # it on, every other backend but "frontier" forces it off.
        if backend == "pallas":
            cfg = dataclasses.replace(cfg, use_pallas=True)
        elif cfg.use_pallas and backend != "frontier":
            cfg = dataclasses.replace(cfg, use_pallas=False)
        self.graph = graph
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.ell: EllGraph | None = None
        self.csr: CsrGraph | None = None
        self.frontier_cap = 0

        if backend in ("ell", "pallas"):
            if ell is None:
                e = graph.e
                ell = build_ell(graph.n, graph.src[:e].cpu().numpy(),
                                graph.dst[:e].cpu().numpy(),
                                graph.w[:e].cpu().numpy(),
                                max_deg_cap=max_deg_cap, device=device)
            self.ell = ell
            self.prims = backends.ell_prims(graph, ell)
        elif backend == "frontier":
            self.csr = graph.csr()
            self.frontier_cap = _next_pow2(
                _default_frontier_cap(graph.n) if frontier_cap is None
                else max(1, int(frontier_cap)))
            self.prims = backends.frontier_prims(graph, self.csr,
                                                 self.frontier_cap)
        else:
            self.prims = backends.segment_prims(graph)

    # ------------------------------------------------------------------
    def _check_sources(self, sources) -> None:
        sources = np.asarray(sources, np.int64)
        bad = sources[(sources < 0) | (sources >= self.graph.n)]
        if bad.size:
            raise ValueError(f"source vertices {bad.tolist()} out of range "
                             f"[0, {self.graph.n})")

    @staticmethod
    def _unported(target, C0) -> None:
        if target is not None or C0 is not None:
            raise NotImplementedError(
                "targeted solves and C0 lower-bound seeds are not ported "
                "yet (ROADMAP A6)")

    def _run(self, sources: np.ndarray, b: int):
        """Engine run of the (padded) ``sources``; returns the state, the
        host copies of ``rounds``/``fixed_by``/``edges`` of the first
        ``b`` lanes (one read) and the run's count of host reads."""
        sync = SyncCounter()
        src = torch.as_tensor(sources, dtype=torch.int64)
        if self.device.type == "cuda":    # an async copy: no host sync
            src = src.pin_memory().to(self.device, non_blocking=True)
        state = _solve(self.graph, self.cfg, src, self.prims, sync)
        meta = [state.round[:b, None], state.fixed_by[:b]]
        if state.edges is not None:
            meta.append(state.edges[:b, None])
        meta = np.asarray(sync.read(torch.cat(meta, dim=1)), np.int64)
        edges = meta[:, 6] if state.edges is not None else None
        return (state, meta[:, 0].astype(np.int32), meta[:, 1:6], edges,
                sync.count)

    def solve(self, source: int, target: int | None = None,
              C0=None) -> SSSPResult:
        """Distances from one source (the engine at B = 1)."""
        self._unported(target, C0)
        self._check_sources([source])
        state, rounds, fb, edges, syncs = self._run(
            np.array([source], np.int64), 1)
        return SSSPResult(
            dist=state.D[0], C=state.C[0], fixed=state.fixed[0],
            rounds=int(rounds[0]), fixed_by=_fixed_by_dict(fb[0]),
            source=int(source), graph=self.graph,
            edges_relaxed=None if edges is None else int(edges[0]),
            host_syncs=syncs)

    def solve_batch(self, sources, targets=None, C0=None) -> SSSPBatchResult:
        """Distances from B sources in one batch-first run.

        The batch is right-padded (repeating the last source) to the next
        power of two, as the reference pads its compiled batch shapes;
        padding lanes are sliced off the result.
        """
        self._unported(targets, C0)
        sources = np.asarray(sources, np.int32).ravel()
        if sources.size == 0:
            raise ValueError("solve_batch needs at least one source")
        self._check_sources(sources)
        b = len(sources)
        padded = np.concatenate(
            [sources, np.full(_next_pow2(b) - b, sources[-1], np.int32)])
        state, rounds, fb, edges, syncs = self._run(padded, b)
        return SSSPBatchResult(
            sources=sources,
            dist=state.D[:b], C=state.C[:b], fixed=state.fixed[:b],
            rounds=rounds, fixed_by=[_fixed_by_dict(f) for f in fb],
            graph=self.graph, edges_relaxed=edges, host_syncs=syncs)
