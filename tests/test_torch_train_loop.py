"""Port parity for the training runtime: 3 steps of the port's
``Trainer`` against the reference's ``Trainer`` (jit, donation) from the
same weights (carried across by ``convert``) on the same seeded streams,
for the qwen3-32b and xDeepFM smoke configs at ``grad_accum`` 1 and 2:
loss, grad norm and lr of every step and the final parameters; the
``TokenStream`` bitwise; a resumed run bitwise an uninterrupted one; and
``launch/train.main`` on the CPU.  Tolerance: float32, rtol 1e-4 and
atol 1e-6 on the history; rtol 1e-3 and atol 1e-5 on the parameters
(AdamW's first steps move each weight by about lr whatever its
gradient's size, so gradients that agree to 1e-5 give weights that do
too)."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import RecsysStream as RefRecsys
from repro.data.synthetic import TokenStream as RefTokens
from repro.models import transformer as rtfm
from repro.models import xdeepfm as rxd
from repro.runtime import train_loop as rtl
from repro_torch import convert
from repro_torch.checkpoint.store import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import RecsysStream, TokenStream
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as ptfm
from repro_torch.models import xdeepfm as pxd
from repro_torch.optim import adamw_init
from repro_torch.runtime import train_loop as ptl
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ref_arch, setup
from test_torch_xdeepfm import REF_SMOKE, _port_cfg

HIST_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
STEPS = 3


def _lm_pair():
    rcfg = ref_arch("qwen3-32b").smoke
    rparams, pcfg, pparams = setup(rcfg, seed=2)
    return (lambda p, b: rtfm.loss_fn(p, b, rcfg), rparams,
            lambda: RefTokens(rcfg.vocab, 24, 4, seed=3).next_batch,
            lambda p, b: ptfm.loss_fn(p, b, pcfg), pparams,
            lambda: TokenStream(pcfg.vocab, 24, 4, seed=3).next_batch,
            lambda tree: convert.lm_params_to_arrays(tree, pcfg))


def _xdeepfm_pair():
    rparams = rxd.init_params(REF_SMOKE, jax.random.PRNGKey(4))
    pparams = convert.xdeepfm_params_from_arrays(rparams, device="cpu")
    sizes, offsets = REF_SMOKE.sizes(), REF_SMOKE.offsets
    return (lambda p, b: rxd.loss_fn(p, b, REF_SMOKE), rparams,
            lambda: RefRecsys(sizes, offsets, 16, seed=5).next_batch,
            pxd.loss_fn, pparams,
            lambda: RecsysStream(sizes, offsets, 16, seed=5).next_batch,
            lambda tree: jax.tree.map(
                lambda t: t.detach().numpy(), tree,
                is_leaf=lambda t: isinstance(t, torch.Tensor)))


@pytest.mark.parametrize("model", ["qwen3-32b", "xdeepfm"])
@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_vs_reference(model, accum):
    rloss, rparams, rstream, ploss, pparams, pstream, to_ref = (
        _lm_pair() if model == "qwen3-32b" else _xdeepfm_pair())
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS, grad_accum=accum,
              clip_norm=0.5)
    ref = rtl.Trainer(rloss, rparams, rtl.TrainConfig(**kw), rstream())
    port = ptl.Trainer(ploss, pparams, ptl.TrainConfig(**kw), pstream())
    want = ref.run(STEPS, print_fn=None)
    got = port.run(STEPS, print_fn=None)
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for key in set(g) - {"step", "step_time_s"}:
            np.testing.assert_allclose(g[key], w[key], **HIST_TOL,
                                       err_msg=key)
    assert int(port.opt_state["step"]) == int(ref.opt_state["step"]) == STEPS
    for a, b in zip(jax.tree.leaves(to_ref(port.params)),
                    jax.tree.leaves(ref.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **PARAM_TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_bitwise(seed):
    a, b = TokenStream(97, 20, 6, seed=seed), RefTokens(97, 20, 6, seed=seed)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert x["tokens"].dtype == y["tokens"].dtype == np.int32
        assert np.array_equal(x["tokens"], y["tokens"])
    for host in range(3):
        assert np.array_equal(a.shard_for_host(x, host, 3)["tokens"],
                              b.shard_for_host(y, host, 3)["tokens"])


def _xdeepfm_trainer(ckpt_dir, batches, tcfg_kw):
    cfg = _port_cfg(REF_SMOKE)
    params = pxd.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    it = iter(batches)
    return ptl.Trainer(pxd.loss_fn, params, ptl.TrainConfig(
        ckpt_dir=ckpt_dir, **tcfg_kw), lambda: next(it))


def test_resumed_run_equals_uninterrupted(tmp_path):
    cfg = REF_SMOKE
    stream = RecsysStream(cfg.sizes(), cfg.offsets, 16, seed=1)
    batches = [stream.next_batch() for _ in range(4)]
    kw = dict(peak_lr=1e-2, warmup=1, total_steps=4, ckpt_every=2)
    whole = _xdeepfm_trainer(None, batches, kw)
    whole.run(4, print_fn=None)
    first = _xdeepfm_trainer(str(tmp_path), batches[:2], kw)
    first.run(2, print_fn=None)
    second = _xdeepfm_trainer(str(tmp_path), batches[2:], kw)
    assert second.maybe_resume() == 2 and second.start_step == 2
    hist = second.run(2, print_fn=None)
    assert [h["step"] for h in hist] == [3, 4]
    assert [h["loss"] for h in hist] == [h["loss"] for h in whole.history[2:]]
    for a, b in zip(tree_leaves(second.params), tree_leaves(whole.params),
                    strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(second.opt_state),
                    tree_leaves(whole.opt_state), strict=True):
        assert torch.equal(a, b)


def test_grad_accum_rejects_a_ragged_batch():
    """A batch of 16 rows does not split into 3 microbatches: the step
    raises rather than train on 15 of them."""
    cfg = REF_SMOKE
    params = pxd.init_params(_port_cfg(cfg), torch.Generator().manual_seed(0),
                             "cpu")
    step = ptl.make_train_step(pxd.loss_fn, ptl.TrainConfig(grad_accum=3))
    batch = RecsysStream(cfg.sizes(), cfg.offsets, 16, seed=1).next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}
    with pytest.raises(ValueError, match="not a multiple of grad_accum=3"):
        step(params, adamw_init(params), batch)


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ptrain.main(argv)
    return rc, out.getvalue()


def test_train_launcher_on_cpu(tmp_path):
    rc, text = _main(["--arch", "qwen3-32b", "--device", "cpu", "--steps",
                      "3", "--batch", "2", "--seq", "16"])
    assert rc == 0 and "done on cpu." in text
    ck = str(tmp_path / "ck")
    common = ["--arch", "xdeepfm", "--device", "cpu", "--steps", "4",
              "--batch", "16", "--ckpt-dir", ck, "--ckpt-every", "2"]
    rc, text = _main(common)
    assert rc == 0 and "done on cpu." in text
    rc, text = _main(common + ["--resume", "auto"])
    assert rc == 0 and "resumed from step 4" in text
    assert get_arch("xdeepfm").kind == "recsys"
    with pytest.raises(SystemExit, match="repro_torch.sssp"):
        _main(["--arch", "sssp", "--device", "cpu"])
