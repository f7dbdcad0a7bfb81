"""Port parity for GNN training and the paths that feed it: the neighbour
sampler equal to the reference's under one seed, 3 steps of the port's
``Trainer`` on a GAT against the reference's ``Trainer`` from the same
weights (history rtol 1e-4 / atol 1e-6, parameters rtol 1e-3 / atol
1e-5, as ``test_torch_train_loop``), the ``train`` launcher's GNN archs
on the CPU (and its raise where there is no CUDA and no ``--device``),
and the distance-feature example: its ``--ci`` fleet's landmark distances
bitwise the reference fleet's, and its ``main`` end to end."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core.graph import HostGraph as RefHostGraph
from repro.data.synthetic import cora_like as ref_cora_like
from repro.models.gnn import gat as rgat
from repro.models.gnn import layers as RL
from repro.models.gnn import sampler as rsampler
from repro.runtime import train_loop as rtl
from repro.sssp import FleetSolver as RefFleetSolver
from repro.sssp import build_fleet as ref_build_fleet
from repro_torch import convert
from repro_torch.checkpoint.store import tree_leaves
from repro_torch.core import generators as pgen
from repro_torch.data.synthetic import cora_like
from repro_torch.launch import train as ptrain
from repro_torch.models.gnn import gat as pgat
from repro_torch.models.gnn import layers as PL
from repro_torch.models.gnn import sampler as psampler
from repro_torch.runtime import train_loop as ptl
from test_torch_graph import _one_torch_thread  # noqa: F401

HIST_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "sssp_gnn_features_torch.py"


@pytest.mark.parametrize("spec", [dict(batch_nodes=64, fanouts=(5, 3)),
                                  dict(batch_nodes=32, fanouts=(15, 10))])
def test_sample_subgraph_equal(spec):
    n, src, dst, _ = pgen.make("gnp", 3000, seed=1, avg_deg=12)
    assert all(np.array_equal(a, b) for a, b in zip(
        (n, src, dst), rgen.make("gnp", 3000, seed=1, avg_deg=12)[:3]))
    g, rg = psampler.CSRGraph(n, src, dst), rsampler.CSRGraph(n, src, dst)
    assert np.array_equal(g.indptr, rg.indptr)
    assert np.array_equal(g.nbr, rg.nbr)
    pspec, rspec = psampler.SamplerSpec(**spec), rsampler.SamplerSpec(**spec)
    assert (pspec.max_nodes, pspec.max_edges) == (rspec.max_nodes,
                                                  rspec.max_edges)
    prng, rrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        seeds = prng.choice(n, pspec.batch_nodes, replace=False)
        assert np.array_equal(seeds, rrng.choice(n, rspec.batch_nodes,
                                                 replace=False))
        got = psampler.sample_subgraph(g, seeds, pspec, prng)
        want = rsampler.sample_subgraph(rg, seeds, rspec, rrng)
        for a, b in zip(got, want, strict=True):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
            assert np.array_equal(a, b)
        _, s, d, nn, ne = got
        assert 0 < ne <= pspec.max_edges and (s[ne:] == pspec.max_nodes).all()
        assert (s[:ne] < nn).all() and (d[:ne] < nn).all()


def test_trainer_gat_vs_reference():
    n, src, dst, x, y = cora_like(n=150, e=500, d=24, seed=2)
    rcfg = rgat.GATConfig(in_dim=24, n_classes=7)
    pcfg = pgat.GATConfig(in_dim=24, n_classes=7)
    ref_b = RL.build_batch(n, src, dst, x, y)
    port_b = PL.build_batch(n, src, dst, x, y, device="cpu")
    rparams = rgat.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = convert.gnn_params_from_arrays(rparams, device="cpu")
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=3, clip_norm=0.5)
    ref = rtl.Trainer(lambda p, b: rgat.loss_fn(p, ref_b, rcfg), rparams,
                      rtl.TrainConfig(**kw), lambda: {"_": np.zeros(1)})
    port = ptl.Trainer(lambda p, b: pgat.loss_fn(p, port_b, pcfg), pparams,
                       ptl.TrainConfig(**kw), lambda: {"_": np.zeros(1)})
    want = ref.run(3, print_fn=None)
    got = port.run(3, print_fn=None)
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for key in set(g) - {"step", "step_time_s"}:
            np.testing.assert_allclose(g[key], w[key], **HIST_TOL,
                                       err_msg=key)
    assert got[-1]["loss"] < got[0]["loss"]
    for a, b in zip(tree_leaves(port.params), jax.tree.leaves(ref.params),
                    strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **PARAM_TOL)


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ptrain.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("arch", ["gat-cora", "pna", "dimenet", "nequip"])
def test_train_launcher_gnn_archs_on_cpu(arch):
    """Every GNN arch trains the reference launcher's GAT on
    ``cora_like(400, 1600, 64)``, as the reference's launcher does."""
    rc, text = _main(["--arch", arch, "--device", "cpu", "--steps", "6",
                      "--lr", "1e-2"])
    assert rc == 0 and text.strip().endswith("done on cpu.")


def test_train_launcher_gat_matches_reference_run():
    """The launcher's GAT run: the reference's data, config and loss."""
    n, src, dst, x, y = cora_like(n=400, e=1600, d=64)
    for a, b in zip((n, src, dst, x, y),
                    ref_cora_like(n=400, e=1600, d=64)):
        assert np.array_equal(a, b)
    batch = PL.build_batch(n, src, dst, x, y, device="cpu")
    assert batch.n_nodes == 400 and batch.src.shape[0] == 1664


def test_train_launcher_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _main(["--arch", "gat-cora", "--steps", "1"])


def _example():
    spec = importlib.util.spec_from_file_location("sssp_gnn_features_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_feature_example_distances_bitwise_reference():
    ex = _example()
    members, solver, landmarks, res = ex.fleet_distances(True, device="cpu")
    F, n, _, _, L, _ = ex.sizes(True)
    fleet = ref_build_fleet(
        [RefHostGraph(n, m[1], m[2], np.ones(len(m[1]), np.float32))
         for m in members])
    want = RefFleetSolver(fleet).solve_batch(landmarks)
    got = res.dist.numpy()
    assert got.shape == (F, L, n) and np.isinf(got).any()
    assert np.array_equal(got, np.asarray(want.dist))
    assert np.array_equal(res.rounds, np.asarray(want.rounds))
    assert solver.solves == F * L


def test_feature_example_main_on_cpu():
    ex = _example()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ex.main(["--ci", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    assert rc == 0
    assert lines[0].startswith("fleet of 2 graphs, n=200 on cpu: 8 landmark")
    accs = [float(l.rsplit("=", 1)[1]) for l in lines if "final acc" in l]
    assert len(accs) == 3 and all(0.0 <= a <= 1.0 for a in accs)
    assert lines[-1].startswith("SP4 positional features delta (graph 0)")
