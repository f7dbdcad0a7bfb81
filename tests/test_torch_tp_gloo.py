"""The sharding rules on real ranks: 4 gloo processes
(``distributed/ranks.spawn_ranks``) on a (2, 2) ``data x model`` mesh run
the smoke qwen3-32b (dense, GQA: 8 query heads, 2 KV heads) and the smoke
deepseek-moe-16b (MoE, expert-parallel over model) with parameters and
batch laid out as DTensors by ``distributed/sharding``: the prefill's
last-position logits, ``DECODE`` ``decode_step``s from an empty cache
sharded (batch over data, sequence over model: 2 ranks of 16 slots, so
the later steps write into the second rank's block and combine real
scores from both ranks), and one train step (loss, gradients
and AdamW with ZeRO-1 moments).  Each is held against the unsharded port
and the reference on the same weights, at the LM tests' own tolerances:
float32 rtol 1e-4 and atol 1e-5 on logits, rtol 1e-4 and atol 1e-6 on
the loss, rtol 1e-3 and atol 1e-5 on the updated parameters.  The ranks
import this module without JAX (its reference side imports it inside
the test)."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.store import map_leaves, tree_items
from repro_torch.models import transformer as ptfm
from repro_torch.optim import adamw_init
from repro_torch.runtime import train_loop as ptl

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the suite's workers share the cores (as
    ``test_torch_graph``'s fixture, defined here so that the ranks, which
    import this module, import no JAX)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
B, S, MAX_SEQ = 4, 16, 32
DECODE = 20                # decode steps: positions 0-19 of MAX_SEQ
TRAIN = dict(peak_lr=1e-3, warmup=2, total_steps=10, clip_norm=0.5)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _np_leaves(tree) -> list:
    """A port tree's leaves as numpy arrays, in the reference's order."""
    return [np.asarray(x) for _, x in tree_items(tree)]


def tp_rank(rank, world, cases):
    """One rank of the (2, 2) mesh: for each ``(arch, reference params,
    tokens, decode tokens)`` of ``cases``, host values of the sharded
    prefill, decode steps and train step."""
    return [_tp_case(*case) for case in cases]


def _tp_case(cfg, rparams, toks, dtoks):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.cells import init_placed_cache
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2, device_type="cpu")
    params = convert.lm_params_from_arrays(rparams, cfg, device="cpu")
    p_sh = shr.tree_shardings(params, mesh, shr.lm_param_spec, cfg)
    dparams = shr.distribute(params, p_sh)
    hooks = shr.lm_hooks(mesh, cfg)
    dp = shr.data_axes(mesh)
    rows = shr.NamedSharding(mesh, (dp, None)).placements
    tok = distribute_tensor(torch.from_numpy(toks), mesh, rows,
                            src_data_rank=None)
    dtok = distribute_tensor(torch.from_numpy(dtoks), mesh, rows,
                             src_data_rank=None)
    out = {}
    with torch.no_grad(), implicit_replication():
        logits, _ = ptfm.forward(dparams, tok[:, :-1], cfg, hooks)
        out["prefill"] = logits[:, -1].full_tensor().numpy()
        cache = init_placed_cache(cfg, mesh, B, MAX_SEQ)
        steps = []
        for t in range(DECODE):
            step_logits, cache = ptfm.decode_step(dparams, cache, dtok[:, t],
                                                  cfg, hooks)
            steps.append(step_logits.full_tensor().numpy())
        out["decode"] = np.stack(steps)
        out["cache_k0"] = cache.k[0].full_tensor().numpy()
    o_sh = shr.opt_state_shardings(p_sh, mesh, params)
    zeros = adamw_init(params)
    opt = {"m": shr.distribute(zeros["m"], o_sh["m"]),
           "v": shr.distribute(zeros["v"], o_sh["v"]), "step": zeros["step"]}
    step = ptl.make_train_step(lambda p, b: ptfm.loss_fn(p, b, cfg, hooks),
                               ptl.TrainConfig(**TRAIN))
    with implicit_replication():
        new, _, metrics = step(dparams, opt, {"tokens": tok})
        out["loss"] = float(metrics["loss"].full_tensor())
        full = map_leaves(lambda t: t.full_tensor().detach(), new)
    out["params"] = _np_leaves(convert.lm_params_to_arrays(full, cfg))
    return out


def _unsharded(arch, pparams, pcfg, toks, dtoks):
    out = {}
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits, _ = ptfm.forward(pparams, t[:, :-1], pcfg)
        out["prefill"] = logits[:, -1].numpy()
        cache = ptfm.init_cache(pcfg, B, MAX_SEQ, device="cpu")
        steps = []
        for i in range(DECODE):
            step_logits, cache = ptfm.decode_step(
                pparams, cache, torch.from_numpy(dtoks[:, i]), pcfg)
            steps.append(step_logits.numpy())
        out["decode"] = np.stack(steps)
        out["cache_k0"] = cache.k[0].numpy()
    step = ptl.make_train_step(lambda p, b: ptfm.loss_fn(p, b, pcfg),
                               ptl.TrainConfig(**TRAIN))
    new, _, metrics = step(pparams, adamw_init(pparams), {"tokens": t})
    out["loss"] = float(metrics["loss"])
    out["params"] = _np_leaves(convert.lm_params_to_arrays(
        map_leaves(lambda x: x.detach(), new), pcfg))
    return out


def _reference(rcfg, rparams, toks, dtoks):
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as rtfm
    from repro.optim import adamw_init as radamw_init
    from repro.runtime import train_loop as rtl
    out = {}
    t = jnp.asarray(toks.astype(np.int32))
    logits, _ = jax.jit(lambda p, x: rtfm.forward(p, x, rcfg))(rparams,
                                                               t[:, :-1])
    out["prefill"] = np.asarray(logits[:, -1])
    decode = jax.jit(lambda p, c, x: rtfm.decode_step(p, c, x, rcfg))
    cache = rtfm.init_cache(rcfg, B, MAX_SEQ)
    steps = []
    for i in range(DECODE):
        step_logits, cache = decode(rparams, cache,
                                    jnp.asarray(dtoks[:, i].astype(np.int32)))
        steps.append(np.asarray(step_logits))
    out["decode"] = np.stack(steps)
    step = rtl.make_train_step(lambda p, b: rtfm.loss_fn(p, b, rcfg),
                               rtl.TrainConfig(**TRAIN))
    new, _, metrics = step(rparams, radamw_init(rparams), {"tokens": t})
    out["loss"] = float(metrics["loss"])
    out["params"] = [np.asarray(x) for x in jax.tree.leaves(new)]
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL,
                               err_msg=f"{what}: prefill")
    np.testing.assert_allclose(got["decode"], want["decode"], **TOL,
                               err_msg=f"{what}: decode")
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL,
                               err_msg=f"{what}: loss")
    g, w = got["params"], want["params"]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **PARAM_TOL,
                                   err_msg=f"{what}: parameters")


ARCHS = ["qwen3-32b", "deepseek-moe-16b"]


def _case(arch):
    from test_torch_lm_model import ref_arch, setup
    rcfg = ref_arch(arch).smoke
    rparams, pcfg, pparams = setup(rcfg, seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rcfg.vocab, (B, S + 1)).astype(np.int64)
    dtoks = rng.integers(0, rcfg.vocab, (B, DECODE)).astype(np.int64)
    return rcfg, rparams, pcfg, pparams, toks, dtoks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both archs on one spawned group of 4 ranks: per arch, every rank's
    results."""
    from repro_torch.distributed.ranks import spawn_ranks
    cases = [(c[2], _np_tree(c[1]), c[4], c[5]) for c in map(_case, ARCHS)]
    outs = spawn_ranks(tp_rank, 4, (cases,),
                       init_dir=str(tmp_path_factory.mktemp("tp")),
                       timeout=120.0, deadline=240.0)
    return {a: [o[i] for o in outs] for i, a in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_on_four_gloo_ranks(arch, ranks):
    outs = ranks[arch]
    for r, o in enumerate(outs[1:], 1):          # every rank holds the same
        np.testing.assert_array_equal(o["prefill"], outs[0]["prefill"],
                                      err_msg=f"rank {r}")
        assert o["loss"] == outs[0]["loss"]
    got = outs[0]
    rcfg, rparams, pcfg, pparams, toks, dtoks = _case(arch)
    plain = _unsharded(arch, pparams, pcfg, toks, dtoks)
    # the decode steps wrote slots on both model ranks' blocks
    assert np.abs(plain["cache_k0"][:, MAX_SEQ // 2:DECODE]).max() > 0
    np.testing.assert_allclose(got["cache_k0"], plain["cache_k0"], **TOL)
    _close(got, plain, "sharded vs unsharded port")
    _close(got, _reference(rcfg, rparams, toks, dtoks),
           "sharded port vs reference")
