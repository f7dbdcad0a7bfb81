"""The port's contract gate (``python -m repro_torch.analysis.check``) on
the CPU: it exits 0 on the clean tree with every route PASS; a host
read and a float64 value seeded into a copy of a real round each make it
exit 1 (unlike the reference's f64 mutant, which its JAX cannot build
any more, this one runs: torch has float64); the AST rules flag seeded
defects and are clean on the port's round scopes; and no module of the
port, no ``examples/*_torch.py`` and not ``chip_smoke.py`` imports
``jax`` or the reference package.
"""
import ast
import json
from pathlib import Path

import pytest

from repro_torch.analysis import astlint, check
from repro_torch.analysis.astlint import lint_file
from test_torch_graph import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_gate_passes_on_the_clean_tree(tmp_path):
    out = tmp_path / "contracts_torch.json"
    assert check.main(["--ci", "--device", "cpu", "--no-ruff",
                       "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["gate"] == "pass" and doc["device"] == "cpu"
    assert doc["summary"] == dict(routes=25, passed=25, known_violations=0,
                                  failed=0)
    assert doc["waivers"] == [] and doc["composition"] == []
    assert doc["astlint"] == []
    for name, v in doc["routes"].items():
        assert v["verdict"] == "PASS" and v["rounds"] > 0, name
        assert v["host_reads"] <= v["read_budget"], name


@pytest.mark.parametrize("kind,rule", [
    ("host_sync", "forbid:aten._local_scalar_dense"),
    ("f64", "dtype:float64")])
def test_mutation_fails_gate(tmp_path, kind, rule):
    out = tmp_path / "contracts.json"
    rc = check.main(["--device", "cpu", "--no-ruff", "--no-astlint",
                     "--mutate", kind, "--out", str(out)])
    assert rc == 1
    doc = json.loads(out.read_text())
    assert doc["gate"] == "fail"
    v = doc["routes"][f"mutant.{kind}"]
    assert v["verdict"] == "FAIL" and v["rounds"] > 0
    assert [x["rule"] for x in v["violations"]] == [rule]
    assert not v["violations"][0]["waived"]


def test_gate_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """``--device cuda`` raises where there is no card; it does not lint
    on the CPU instead."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check.main(["--device", "cuda", "--no-ruff", "--no-astlint",
                    "--out", str(tmp_path / "c.json")])


def test_gate_defaults_to_cuda(tmp_path, monkeypatch):
    """Without ``--device`` the gate targets the card, as every entry
    point of the port does: here, with no card, it raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check.main(["--no-ruff", "--no-astlint",
                    "--out", str(tmp_path / "c.json")])


def test_route_filter(tmp_path):
    out = tmp_path / "c.json"
    assert check.main(["--device", "cpu", "--routes", "segment.*",
                       "--no-ruff", "--no-astlint", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert sorted(doc["routes"]) == ["segment.batched", "segment.cold",
                                     "segment.targeted", "segment.warm"]
    # a partial sweep audits no waivers and no compositions
    assert doc["waivers"] == [] and doc["composition"] == []


_BAD_MODULE = '''
import torch


def _round(g, x, cfg, sync):
    if x.sum() > 0:                 # tensor branch
        x = x * 2
    y = float(x.max())              # host read by cast
    z = x.min().item()              # host read
    v = x.tolist()                  # host read
    k = x.sum().item()              # astlint: ignore[host-sync]
    if cfg.early_exit:              # static config: NOT flagged
        y = y + 1
    n = sync.read(x.any())          # a counted read: NOT flagged
    while sync.read(x.any()):       # NOT flagged
        break
    if n:                           # a host value: NOT flagged
        y = y + 1
    for it in range(cfg.c_prop_iters):
        if it:                      # a loop counter: NOT flagged
            y = y + 1
    return y + z + k + len(v)


def _loop(x, sync):
    return x.item()                 # not a round scope: NOT flagged
'''


def test_astlint_flags_seeded_defects(tmp_path):
    mod = tmp_path / "bad.py"
    mod.write_text(_BAD_MODULE)
    findings = lint_file(mod, tmp_path, ("_round",))
    got = [(f.rule, f.line) for f in findings]
    assert got == [("tensor-branch", 6), ("host-sync", 8),
                   ("host-sync", 9), ("host-sync", 10)], got


def test_astlint_graphdelta_rule(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "core" / "sssp"
    pkg.mkdir(parents=True)
    (pkg / "dynamic.py").write_text("d = GraphDelta(k=1)\n")   # allowed
    (pkg / "other.py").write_text(
        "a = GraphDelta(k=1)\n"
        "b = GraphDelta(k=2)  # astlint: ignore[raw-graphdelta]\n")
    findings = astlint.run(tmp_path)
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("raw-graphdelta", "src/repro_torch/core/sssp/other.py", 1)]


def test_astlint_clean_on_the_port_round_scopes():
    """The port's own round scopes stay lint-clean: the same invariant
    the gate enforces, pinned as a fast test."""
    findings = astlint.run(ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def _port_files() -> list[Path]:
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + [ROOT / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 80
    assert {"quickstart_torch.py", "sssp_dynamic_torch.py",
            "sssp_p2p_torch.py", "sssp_distributed_torch.py",
            "serve_lm_torch.py", "train_lm_torch.py",
            "sssp_gnn_features_torch.py"} <= {p.name for p in files}
    bad = {}
    for path in files:
        hits = sorted(m for m in _imports(path)
                      if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert bad == {}
