"""Port parity for bidirectional point-to-point queries
(``repro_torch.core.sssp.bidirectional``): ``BidirectionalSolver.solve``
on the segment and frontier routes bitwise against the reference's, field
for field (both lanes' D/C/fixed, rounds, fixed_by, mu, meeting,
distance, edges_relaxed, path), and against the port's full ``Solver``:
``dist[t]`` bitwise, the stitched path made of real edges that refolds to
the same bits.  Also self and unreachable pairs, bad inputs, landmark
seeds that never change an answer, the forward lane as a partial result,
the first minimum on a tie, the host reads of a solve, and a near-tie
where both packages stitch a near-shortest path whose fold exceeds
``dist[t]`` (the parent pointers' tolerance)."""
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp.bidirectional import BidirectionalSolver as RBidi
from repro.core.sssp.landmarks import LandmarkIndex as RIndex
import repro_torch.sssp as P
from repro_torch.convert import graph_from_arrays
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


def _same(a, b):
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _bits(x):
    return np.float32(x).tobytes()


def graphs(family, n=160, seed=11):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def assert_bidi_equal(ra, pb):
    """A reference and a port ``BidiResult``, field for field."""
    assert _same(ra.D, pb.D) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert (ra.source, ra.target, ra.rounds, ra.fixed_by, ra.meeting,
            ra.edges_relaxed) == (pb.source, pb.target, pb.rounds,
                                  pb.fixed_by, pb.meeting, pb.edges_relaxed)
    assert _bits(ra.distance) == _bits(pb.distance)
    assert _bits(ra.mu) == _bits(pb.mu)
    assert ra.path() == pb.path()


def edge_mins(g):
    e = g.e
    out = {}
    for a, b, w in zip(g.src[:e].tolist(), g.dst[:e].tolist(),
                       g.w[:e].numpy()):
        if (a, b) not in out or w < out[(a, b)]:
            out[(a, b)] = w
    return out


def check_pair(res, full, t, wmap):
    """``res`` agrees with the full solve's ``dist[t]`` bitwise, and its
    path is made of real edges whose f32 fold is that value."""
    exp = np.float32(full.dist[t].item())
    if not np.isfinite(exp):
        assert not np.isfinite(res.distance) and res.path() is None
        assert res.meeting is None
        return
    assert _bits(res.distance) == exp.tobytes()
    p = res.path()
    assert p[0] == res.source and p[-1] == t
    acc = np.float32(0.0)
    for a, b in zip(p, p[1:]):
        assert (a, b) in wmap, f"stitched path uses non-edge {(a, b)}"
        acc = np.float32(acc + wmap[(a, b)])
    assert acc.tobytes() == exp.tobytes()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_bitwise_vs_reference_and_full(family, backend):
    rg, pg = graphs(family)
    rb = RBidi(rg, backend=backend)
    pb = P.BidirectionalSolver(pg, backend=backend, device="cpu")
    assert pb.backend == backend
    if backend == "frontier":
        assert pb.frontier_cap == rb.frontier_cap >= pg.n
    s = 3 % pg.n
    full = P.Solver(pg, backend="segment", device="cpu").solve(s)
    wmap = edge_mins(pg)
    for t in (0, s, 7 % pg.n, pg.n // 2, pg.n - 1):
        ra, res = rb.solve(s, t), pb.solve(s, t)
        assert_bidi_equal(ra, res)
        check_pair(res, full, t, wmap)
        assert res.rounds <= full.rounds + 1
        assert (res.edges_relaxed is not None) == (backend == "frontier")


def test_bidi_auto_route_matches_reference():
    for family in FAMILIES:
        rg, pg = graphs(family, n=60)
        assert (P.BidirectionalSolver(pg, device="cpu").backend
                == RBidi(rg).backend)


def test_bidi_self_and_unreachable():
    # dag: vertex 0 has no in-edge, so nothing but itself reaches it
    rg, pg = graphs("dag", n=60)
    bidi = P.BidirectionalSolver(pg, backend="segment", device="cpu")
    rb = RBidi(rg, backend="segment")
    r = bidi.solve(4, 4)
    assert r.distance == 0.0 and r.path() == [4] and r.meeting == 4
    assert_bidi_equal(rb.solve(4, 4), r)
    r = bidi.solve(5, 0)
    assert not np.isfinite(r.distance)
    assert r.path() is None and r.meeting is None
    assert_bidi_equal(rb.solve(5, 0), r)


def test_bidi_rejects_bad_inputs():
    _, pg = graphs("gnp", n=40)
    with pytest.raises(ValueError):
        P.BidirectionalSolver(pg, backend="nope", device="cpu")
    with pytest.raises(TypeError):
        P.BidirectionalSolver("graph", device="cpu")
    bidi = P.BidirectionalSolver(pg, device="cpu")
    with pytest.raises(ValueError):
        bidi.solve(-1, 0)
    with pytest.raises(ValueError):
        bidi.solve(0, pg.n)
    with pytest.raises(ValueError):
        bidi.solve(0, 1, C0=np.zeros((3, pg.n)))
    other = graph_from_arrays(rbuild(*rgen.make("gnp", 40, seed=9)),
                              device="cpu")
    if other.e != pg.e:
        with pytest.raises(ValueError, match="reverse graph shape"):
            P.BidirectionalSolver(pg, rgraph=other.reverse(), device="cpu")


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_seeds_never_change_answers(backend):
    rg, pg = graphs("geometric")
    ri, pi = RIndex(rg, k=4, seed=3), P.LandmarkIndex(pg, k=4, seed=3)
    plain = P.BidirectionalSolver(pg, backend=backend, device="cpu")
    seeded = P.BidirectionalSolver(pg, backend=backend, landmarks=pi,
                                   device="cpu")
    rseeded = RBidi(rg, backend=backend, landmarks=ri)
    for s, t in ((2, pg.n - 3), (0, 77), (19, 5)):
        r0, r1 = plain.solve(s, t), seeded.solve(s, t)
        assert _bits(r0.distance) == _bits(r1.distance)
        assert r1.rounds <= r0.rounds
        assert_bidi_equal(rseeded.solve(s, t), r1)
        # an explicit C0 is the same as the index's seeds
        assert_bidi_equal(r1, plain.solve(s, t, C0=pi.seed_pair(s, t)))


def test_bidi_forward_lane_is_a_valid_partial_result():
    _, pg = graphs("grid")
    bidi = P.BidirectionalSolver(pg, backend="segment", device="cpu")
    full = P.Solver(pg, backend="segment", device="cpu").solve(2).dist
    r = bidi.solve(2, pg.n - 1)
    part = r.forward_result()
    assert part.partial and part.source == 2 and part.target == pg.n - 1
    fixed = part.fixed
    assert fixed.any()
    assert torch.equal(part.dist[fixed], full[fixed])


def test_bidi_matches_dijkstra_sample():
    _, pg = graphs("power_law")
    bidi = P.BidirectionalSolver(pg, backend="segment", device="cpu")
    hg = pg.to_host()
    rng = np.random.default_rng(0)
    for s, t in rng.integers(0, pg.n, (4, 2)):
        want = P.dijkstra(hg, source=int(s)).dist[int(t)]
        got = bidi.solve(int(s), int(t)).distance
        if np.isinf(want):
            assert np.isinf(got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_meeting_is_the_first_minimum_on_a_tie(backend):
    """Two shortest paths 0 -> {1, 2} -> 3 of equal weight tie in
    D_f + D_b at vertices 1 and 2: the meeting vertex is the first."""
    src = np.array([0, 0, 1, 2, 3])
    dst = np.array([1, 2, 3, 3, 4])
    w = np.array([1.0, 1.0, 1.0, 1.0, 2.0], np.float32)
    rg = rbuild(5, src, dst, w)
    pg = graph_from_arrays(rg, device="cpu")
    r = P.BidirectionalSolver(pg, backend=backend, device="cpu").solve(0, 3)
    score = r.D[0] + r.D[1]
    ties = torch.nonzero(score == score.min()).ravel().tolist()
    assert len(ties) > 1 and r.meeting == ties[0]
    assert_bidi_equal(RBidi(rg, backend=backend).solve(0, 3), r)
    assert torch.argmin(torch.tensor([3.0, 1.0, 2.0, 1.0])).item() == 1


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_host_reads_pinned(backend):
    """One host read a round and one after the last (the termination
    predicate), one for the stats and, when t is reachable, one for both
    lanes' parent pointers."""
    _, pg = graphs("grid")
    bidi = P.BidirectionalSolver(pg, backend=backend, device="cpu")
    r = bidi.solve(3, pg.n - 1)
    assert r.rounds > 2 and r.host_syncs == r.rounds + 3
    _, dag = graphs("dag", n=60)
    r = P.BidirectionalSolver(dag, backend=backend, device="cpu").solve(5, 0)
    assert r.host_syncs == r.rounds + 2


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_path_follows_the_reference_parent_tolerance(backend):
    """The stitched path takes parent pointers within the reference's
    ``atol = 1e-5 * (1 + D)``, the smallest-index feasible parent first,
    so it can be a near-shortest path whose f32 fold exceeds ``dist[t]``:
    here 0 -> 1 -> 3 (1000 + 1000.01) against 0 -> 2 -> 3 (2000).  Both
    packages answer so; ``mu`` keeps the exact two-lane minimum."""
    src, dst = np.array([0, 0, 1, 2]), np.array([1, 2, 3, 3])
    w = np.array([1000.0, 1000.0, 1000.01, 1000.0], np.float32)
    rg = rbuild(4, src, dst, w)
    pg = graph_from_arrays(rg, device="cpu")
    r = P.BidirectionalSolver(pg, backend=backend, device="cpu").solve(0, 3)
    assert_bidi_equal(RBidi(rg, backend=backend).solve(0, 3), r)
    full = P.Solver(pg, backend="segment", device="cpu").solve(0).dist[3]
    assert r.path() == [0, 1, 3]
    assert r.distance == np.float32(np.float32(1000.0) + np.float32(1000.01))
    assert r.distance > full.item() and r.mu == full.item()
