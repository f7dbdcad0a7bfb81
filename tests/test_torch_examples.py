"""The port's examples (``examples/*_torch.py``) on the CPU: every
example's ``main(["--ci", "--device", "cpu"])`` returns 0 (its own
assertions against Dijkstra, a cold solve or one device hold), and each
is held against the reference package on the same inputs:

  * quickstart: SP1..SP4 and SP4+cprop4 ``rounds``, ``fixed_by`` and
    distances bitwise the reference ``Solver``'s;
  * sssp_dynamic, sssp_p2p: the warm, targeted, seeded and served
    distances bitwise the reference flow's (the same deltas, landmarks
    and queries);
  * sssp_distributed: two spawned gloo ranks bitwise the one-device
    solve;
  * serve_lm: greedy tokens (temperature 0) on the reference's weights,
    carried across by ``convert``, equal the reference ``BatchServer``'s;
  * train_lm: the ``tiny`` preset's first 3 steps (loss, grad norm, lr)
    allclose to the reference ``Trainer``'s from the same weights, at the
    training tests' float32 tolerance (rtol 1e-4, atol 1e-6).
"""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from test_torch_graph import _one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ["quickstart", "sssp_dynamic", "sssp_p2p", "sssp_distributed",
         "serve_lm", "train_lm"]
HIST_TOL = dict(rtol=1e-4, atol=1e-6)


def example(name: str):
    """``examples/<name>_torch.py`` as a module (registered under its
    name, so spawned ranks and pickles find its functions)."""
    mod_name = f"{name}_torch"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod_name, EXAMPLES / f"{mod_name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def _quiet(*_):
    pass


@pytest.mark.parametrize("name", NAMES)
def test_example_main_ci(name, tmp_path, capsys):
    argv = ["--ci", "--device", "cpu"]
    if name == "train_lm":
        argv += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    assert example(name).main(argv) == 0
    out = capsys.readouterr().out
    assert "cpu" in out
    if name == "train_lm":       # a resumed run continues from step 6
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "step_3", "step_6"]
        assert example(name).main(argv + ["--resume", "auto"]) == 0
        assert "resumed at step 6" in capsys.readouterr().out


def test_quickstart_engine_bitwise_reference():
    from repro.core import generators as rgen
    from repro.core.graph import HostGraph as RHost
    from repro.sssp import Solver as RSolver
    from repro.sssp import SSSPConfig as RConfig
    from repro_torch.core import generators as pgen
    from repro_torch.core.graph import HostGraph
    ex = example("quickstart")
    arrays = pgen.make("gnp", 300, seed=0)
    got = ex.engine_runs(HostGraph(*arrays).to_device("cpu"), "cpu")
    rg = RHost(*rgen.make("gnp", 300, seed=0)).to_device()
    for name, cfg in ex.configs().items():
        rcfg = RConfig(rules=cfg.rules, label_correcting=cfg.label_correcting,
                       c_prop_iters=cfg.c_prop_iters)
        want = RSolver(rg, rcfg).solve(0)
        res = got[name]
        assert res.rounds == int(want.rounds), name
        assert res.fixed_by == {k: int(v) for k, v in
                                want.fixed_by.items()}, name
        assert np.array_equal(res.dist.numpy(), np.asarray(want.dist)), name


def _ref_service_query(R, hg, backend, k, seed, n):
    """The reference example's serving loop up to its post-delta query."""
    from repro.runtime.sssp_service import Query, SSSPService
    service = SSSPService(hg.to_device(), backend=backend, batch=4)
    rng = np.random.default_rng(seed)
    hot = [int(s) for s in rng.choice(n, size=4, replace=False)]
    service.serve([Query(source=s, target=int(rng.integers(0, n)))
                   for s in hot for _ in range(4)])
    service.apply_delta(R.random_delta(service.solver.graph, k, seed=123))
    q = Query(source=hot[0], target=int(rng.integers(0, n)))
    service.serve([q])
    return q


def test_sssp_dynamic_bitwise_reference():
    import repro.sssp as R
    from repro.core import generators as rgen
    from repro.core.graph import HostGraph as RHost
    ex = example("sssp_dynamic")
    args = ex.parse(["--ci", "--device", "cpu"])
    got = ex.run(args, log=_quiet)

    n, src, dst, w = rgen.make(args.family, args.n, seed=args.seed)
    hg = RHost(n, src, dst, w)
    dyn = R.DynamicSolver(hg.to_device(), backend=args.backend)
    dyn.solve_batch(got["sources"])
    k = max(1, hg.e // 100)
    for step in range(args.deltas):
        dyn.update(R.random_delta(dyn.graph, k, seed=args.seed + 7 * step,
                                  lo=0.5, hi=2.0))
    want = np.asarray(dyn.resolve(got["sources"]).dist)
    assert np.array_equal(got["warm"], want)
    assert np.array_equal(got["cold"], want)
    q = _ref_service_query(R, hg, args.backend, k, args.seed, n)
    assert got["served"] == (q.distance, q.path)


def test_sssp_p2p_bitwise_reference():
    import repro.sssp as R
    from repro.core import generators as rgen
    from repro.core.graph import HostGraph as RHost
    from repro.runtime.sssp_service import Query, SSSPService
    ex = example("sssp_p2p")
    args = ex.parse(["--ci", "--device", "cpu"])
    got = ex.run(args, log=_quiet)

    n, src, dst, w = rgen.make(args.family, args.n, seed=args.seed)
    hg = RHost(n, src, dst, w)
    g = hg.to_device()
    solver = R.Solver(g, backend=args.backend)
    index = R.LandmarkIndex(g, args.landmarks, backend=args.backend,
                            seed=args.seed)
    assert got["landmarks"] == np.asarray(index.landmarks).tolist()
    rng = np.random.default_rng(args.seed)
    pairs, full = [], []
    for _ in range(args.queries):
        s = int(rng.integers(n))
        d = np.asarray(solver.solve(s).dist)
        reach = np.flatnonzero(np.isfinite(d) & (d > 0))
        if not reach.size:
            continue
        t = int(rng.choice(reach))
        seeded = solver.solve(s, target=t, C0=index.seed(s))
        pairs.append((s, t, float(d[t]), float(seeded.dist[t])))
        full.append(d)
    assert got["pairs"] == pairs and len(pairs) > 1
    for a, b in zip(got["full"], full, strict=True):
        assert np.array_equal(a, b)
    service = SSSPService(hg.to_device(), backend=args.backend, batch=4,
                          landmarks=args.landmarks)
    queries = [Query(source=int(rng.integers(n)),
                     target=int(rng.integers(n))) for _ in range(12)]
    service.serve(queries)
    service.apply_delta(R.random_delta(service.solver.graph,
                                       max(1, hg.e // 100),
                                       seed=args.seed + 1))
    q = Query(source=queries[0].source, target=queries[0].target)
    service.serve([q])
    assert got["served"] == [x.distance for x in queries] + [q.distance]


def test_sssp_distributed_world_2_bitwise_one_device():
    import torch
    ex = example("sssp_distributed")
    single, _ = ex.solve_single(2000, 8.0, torch.device("cpu"), source=3)
    ranks = ex.solve_sharded(2000, 8.0, 2, "cpu", source=3)
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    for r in ranks:
        assert np.array_equal(r["dist"], single.dist.numpy())
        assert r["rounds"] == single.rounds
        # the relax with inWeight_nf, then the C-propagation: 2 a round
        assert r["all_reduces"] == 2 * single.rounds


def test_serve_lm_greedy_tokens_equal_reference():
    from repro.models.transformer import LMConfig as RLM
    from repro.models.transformer import init_params as rinit
    from repro.runtime import serve_loop as rserve
    from repro_torch import convert
    from repro_torch.models.transformer import LMConfig
    from repro_torch.runtime import serve_loop as pserve
    ex = example("serve_lm")
    rcfg, pcfg = RLM(**ex.CONFIG), LMConfig(**ex.CONFIG)
    rparams = rinit(rcfg, jax.random.PRNGKey(0))
    pparams = convert.lm_params_from_arrays(rparams, pcfg, device="cpu")
    want = rserve.BatchServer(rparams, rcfg, batch=2, max_seq=28,
                              temperature=0.0).generate(
        ex.requests(rserve, rcfg.vocab, 2, 12, 8))
    got = pserve.BatchServer(pparams, pcfg, batch=2, max_seq=28,
                             temperature=0.0, device="cpu").generate(
        ex.requests(pserve, pcfg.vocab, 2, 12, 8))
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [8, 8]


def test_train_lm_tiny_first_losses_allclose_reference():
    from repro.data.synthetic import TokenStream as RTokens
    from repro.models import transformer as rtfm
    from repro.runtime import train_loop as rtl
    from repro_torch import convert
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as ptfm
    from repro_torch.runtime import train_loop as ptl
    ex = example("train_lm")
    fields, steps, batch, seq, lr = ex.PRESETS["tiny"]
    rcfg, pcfg = rtfm.LMConfig(**fields), ptfm.LMConfig(**fields)
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = convert.lm_params_from_arrays(rparams, pcfg, device="cpu")
    ref = rtl.Trainer(lambda p, b: rtfm.loss_fn(p, b, rcfg), rparams,
                      ex.train_config(rtl, steps, lr, None, 100),
                      RTokens(rcfg.vocab, seq, batch, seed=0).next_batch)
    port = ptl.Trainer(lambda p, b: ptfm.loss_fn(p, b, pcfg), pparams,
                       ex.train_config(ptl, steps, lr, None, 100),
                       TokenStream(pcfg.vocab, seq, batch,
                                   seed=0).next_batch)
    want, got = ref.run(3, print_fn=None), port.run(3, print_fn=None)
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want, strict=True):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], **HIST_TOL,
                                       err_msg=key)
