"""The source edits of the backward kernels' mutation check and ablations
(``tools/bwd_mutants.py``, ``tools/attn_bwd_ablations.py``) against the
CUDA sources: every edit's anchor occurs exactly once, so each tool
builds what it says.  The builds themselves run on the card."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels import _build

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn", sorted(_tool("bwd_mutants").MUTANTS))
def test_each_mutant_plants_its_fault(fn):
    src, anchor, planted = _tool("bwd_mutants").MUTANTS[fn]
    assert _build.SIGNATURES[fn][0] + ".cu" == src
    text = _build.edit_source(fn, [(anchor, planted)])
    assert planted in text and anchor not in text.replace(planted, "")


@pytest.mark.parametrize("name",
                         sorted(_tool("attn_bwd_ablations").VARIANTS))
def test_each_ablation_applies(name):
    edits = _tool("attn_bwd_ablations").VARIANTS[name]
    text = _build.edit_source("flash_attention_bwd", edits)
    assert all(new in text for _, new in edits)


def test_an_edit_whose_anchor_is_missing_raises():
    with pytest.raises(ValueError, match="0 times"):
        _build.edit_source("cin_weight_grad", [("no such line", "")])
