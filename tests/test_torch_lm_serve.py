"""Port parity for LM serving: the port's ``BatchServer`` (batched
prefill, then decode steps) against the reference's (one jitted decode
step a prompt token) on the same requests and weights: greedy tokens
equal, groups and ragged prompts included.  Also: sampling at
temperature > 0 follows the server's generator, and the ``serve``
launcher runs on the CPU when told to."""
import numpy as np
import pytest
import torch

from repro.runtime import serve_loop as rserve
from repro_torch.launch import serve as plaunch
from repro_torch.runtime import serve_loop as pserve
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ref_arch, setup


def _requests(mod, vocab, seed):
    """Five requests with ragged prompts (left-padded into groups of 2)
    and different ``max_new``: three groups, the last one short."""
    rng = np.random.default_rng(seed)
    lens, news = (9, 14, 5, 20, 11), (6, 4, 8, 3, 5)
    return [mod.Request(prompt=rng.integers(0, vocab, n).tolist(),
                        max_new=m) for n, m in zip(lens, news)]


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_batch_server_greedy_tokens_equal_reference(arch):
    rcfg = ref_arch(arch).smoke
    rparams, pcfg, pparams = setup(rcfg)
    want = rserve.BatchServer(rparams, rcfg, batch=2, max_seq=40).generate(
        _requests(rserve, rcfg.vocab, seed=3))
    got = pserve.BatchServer(pparams, pcfg, batch=2, max_seq=40,
                             device="cpu").generate(
        _requests(pserve, rcfg.vocab, seed=3))
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [6, 4, 8, 3, 5]
    assert all(r.done for r in got)


def test_sampling_follows_the_generator():
    _, pcfg, pparams = setup(ref_arch("qwen3-32b").smoke)

    def run(seed):
        server = pserve.BatchServer(pparams, pcfg, batch=2, max_seq=40,
                                    temperature=0.8, seed=seed, device="cpu")
        return [r.out for r in server.generate(
            _requests(pserve, pcfg.vocab, seed=5)[:4])]
    a, b, c = run(7), run(7), run(8)
    assert a == b
    assert a != c
    greedy = pserve.BatchServer(pparams, pcfg, batch=2, max_seq=40,
                                device="cpu").generate(
        _requests(pserve, pcfg.vocab, seed=5)[:4])
    assert a != [r.out for r in greedy]


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, -1.0, 2.5]])
    assert pserve.sample_token(logits, None, 0.0).tolist() == [1, 2]
    assert pserve.sample_token(logits, None, 0.0).dtype == torch.int32
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([pserve.sample_token(logits * 10, g, 1.0)
                         for _ in range(50)])
    assert draws.dtype == torch.int32
    assert (draws == torch.tensor([1, 2])).float().mean() > 0.95


def test_server_checks_the_parameters_device():
    _, pcfg, pparams = setup(ref_arch("qwen3-32b").smoke)
    with pytest.raises(ValueError, match="parameters on cpu"):
        pserve.BatchServer(pparams, pcfg, batch=2, max_seq=40,
                           device="meta")


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-32b", []),
    ("llama4-maverick-400b-a17b", ["--prompt-len", "24", "--max-new", "4"]),
    ("deepseek-moe-16b", ["--temperature", "0.7", "--batch", "2"])])
def test_serve_launcher_on_cpu(arch, extra, capsys):
    assert plaunch.main(["--arch", arch, "--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    batch = 2 if "--batch" in extra else 4
    max_new = 4 if "--max-new" in extra else 32
    assert f"generated {batch * max_new} tokens" in out
    assert "tok/s batched) on cpu" in out
    assert out.count("req") == 2
