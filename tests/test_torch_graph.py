"""Port parity: generators, graph containers and layouts of ``repro_torch``
against ``repro`` on the same seeds, element for element; the converter;
import hygiene of the port; and the no-CUDA behaviour of its entry
points."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core import graph as rgraph
from repro_torch import convert
from repro_torch.core import generators as pgen
from repro_torch.core import graph as pgraph

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch's thread pool from oversubscribing
    the cores the other workers use."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(ref_arr, port_t):
    a = np.asarray(ref_arr)
    b = port_t.cpu().numpy() if isinstance(port_t, torch.Tensor) else port_t
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [60, 300])
def test_generators_same_arrays(family, n):
    a = rgen.make(family, n, seed=11)
    b = pgen.make(family, n, seed=11)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("family", FAMILIES)
def test_graph_csr_ell_same_arrays(family):
    n, src, dst, w = rgen.make(family, 300, seed=4)
    rg = rgraph.build_graph(n, src, dst, w)
    pg = pgraph.build_graph(n, src, dst, w, device="cpu")
    assert (rg.n, rg.e, rg.e_pad) == (pg.n, pg.e, pg.e_pad)
    for f in ("src", "dst", "w", "in_deg", "out_deg", "in_weight",
              "out_weight"):
        assert _eq(getattr(rg, f), getattr(pg, f)), f
    rc, pc = rg.csr(), pg.csr()
    assert (rc.max_out_deg, rc.max_in_deg) == (pc.max_out_deg,
                                               pc.max_in_deg)
    for f in ("indptr", "dst", "w", "in_indptr"):
        assert _eq(getattr(rc, f), getattr(pc, f)), f
    re_, pe = rgraph.build_ell(n, src, dst, w), pgraph.build_ell(
        n, src, dst, w, device="cpu")
    assert (re_.n, re_.n_pad, re_.deg_pad) == (pe.n, pe.n_pad, pe.deg_pad)
    assert _eq(re_.in_src, pe.in_src) and _eq(re_.in_w, pe.in_w)


@pytest.mark.parametrize("lane,sublane", [(128, 8), (4, 3), (1, 1)])
def test_vectorised_build_ell_matches_loop(lane, sublane):
    """Parallel edges and unsorted input: slots follow stable dst order."""
    rng = np.random.default_rng(2)
    n = 37
    src = rng.integers(0, n, 400)
    dst = rng.integers(0, n, 400)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
    a = rgraph.build_ell(n, src, dst, w, lane=lane, sublane=sublane)
    b = pgraph.build_ell(n, src, dst, w, lane=lane, sublane=sublane,
                         device="cpu")
    assert (a.n_pad, a.deg_pad) == (b.n_pad, b.deg_pad)
    assert _eq(a.in_src, b.in_src) and _eq(a.in_w, b.in_w)


def test_build_ell_degree_cap_and_empty():
    n, src, dst, w = rgen.make("power_law", 200, seed=1)
    with pytest.raises(ValueError, match="ELL cap"):
        pgraph.build_ell(n, src, dst, w, max_deg_cap=4, device="cpu")
    a = rgraph.build_ell(5, [], [], [])
    b = pgraph.build_ell(5, [], [], [], device="cpu")
    assert _eq(a.in_src, b.in_src) and _eq(a.in_w, b.in_w)


def test_build_graph_rejects_invalid_edges():
    with pytest.raises(ValueError, match="positive"):
        pgraph.build_graph(3, [0], [1], [0.0], device="cpu")
    with pytest.raises(ValueError, match="loop"):
        pgraph.build_graph(3, [1], [1], [1.0], device="cpu")
    with pytest.raises(ValueError, match="range"):
        pgraph.build_graph(3, [0], [3], [1.0], device="cpu")


@pytest.mark.parametrize("family", ["gnp", "grid", "power_law"])
def test_segment_primitives_match_reference(family):
    n, src, dst, w = rgen.make(family, 200, seed=6)
    rg = rgraph.build_graph(n, src, dst, w)
    pg = pgraph.build_graph(n, src, dst, w, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 5, n).astype(np.float32)
    x[rng.random(n) < 0.3] = np.inf
    assert _eq(rg.gather_src(x), pg.gather_src(torch.from_numpy(x)))
    vals = np.asarray(rg.gather_src(x)) + np.asarray(rg.w)
    got = pg.seg_min_at_dst(torch.from_numpy(vals)[None].repeat(3, 1))
    want = np.asarray(rg.seg_min_at_dst(vals))
    for b in range(3):
        assert _eq(want, got[b])


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_carries_reference_containers(family):
    n, src, dst, w = rgen.make(family, 150, seed=9)
    rg = rgraph.build_graph(n, src, dst, w)
    pg = convert.graph_from_arrays(rg, device="cpu")
    built = pgraph.build_graph(n, src, dst, w, device="cpu")
    for f in ("src", "dst", "w", "in_deg", "out_deg", "in_weight",
              "out_weight"):
        assert torch.equal(getattr(pg, f), getattr(built, f)), f
    pc = convert.csr_from_arrays(rg.csr(), device="cpu")
    for f in ("indptr", "dst", "w", "in_indptr"):
        assert _eq(getattr(rg.csr(), f), getattr(pc, f))
    pe = convert.ell_from_arrays(rgraph.build_ell(n, src, dst, w),
                                 device="cpu")
    be = pgraph.build_ell(n, src, dst, w, device="cpu")
    assert torch.equal(pe.in_src, be.in_src)
    assert torch.equal(pe.in_w, be.in_w)


def test_host_graph_round_trip():
    n, src, dst, w = rgen.make("chain", 80, seed=3)
    hg = pgraph.HostGraph(n, src, dst, w)
    g = hg.to_device("cpu")
    back = g.to_host()
    assert back.n == n and back.e == len(src)
    assert sorted(zip(back.src, back.dst)) == sorted(zip(hg.src, hg.dst))
    assert hg.reverse().reverse().out == hg.out


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(p.name, m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.sssp, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.models.transformer, "
            "repro_torch.runtime.serve_loop, repro_torch.launch.serve, "
            "repro_torch.configs.qwen3_32b, repro_torch.optim, "
            "repro_torch.runtime.train_loop, repro_torch.launch.train; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    """Without a card the default device raises; nothing falls back."""
    from repro_torch.sssp import Solver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n, src, dst, w = rgen.make("gnp", 50, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver((n, src, dst, w))
    with pytest.raises(RuntimeError, match="CUDA"):
        pgraph.build_graph(n, src, dst, w)
    g = pgraph.build_graph(n, src, dst, w, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(g)
    assert Solver(g, device="cpu").solve(0).dist.device.type == "cpu"

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import BatchServer
    cfg = get_arch("qwen3-32b").smoke
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_params(cfg, gen)
    params = tfm.init_params(cfg, gen, device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchServer(params, cfg, batch=2, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_cache(cfg, 2, 16)
    BatchServer(params, cfg, batch=2, max_seq=16, device="cpu")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "xdeepfm", "--steps", "1"])
