"""``BENCHMARK.json`` against the contract's shape, every cell resolved to
its files by name, a configuration added as a file found with no other
edit, and no module of ``jax`` or of the JAX package ``repro`` loaded by
a run or imported by the harness."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import bench

SPEC = bench.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves and m["layer"].strip()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_to_its_files(w):
    cell = bench.cell(w["name"])
    assert cell.chips == 1
    assert (bench.PACKAGE / "graphs"
            / f"{cell.config['generator']}.py").exists()
    bench.generator(cell.config)
    assert (bench.PACKAGE / "traffic" / f"{w['traffic']}.json").exists()
    reported = {m.name for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(bench.reader(m))
        assert (bench.PACKAGE / "metrics" / f"{m.base}.py").exists()
    for m in cell.per_layer:
        spec = next(x for x in SPEC["per_layer"] if x["name"] == m.name)
        assert spec["moves"] in reported


def test_every_configuration_is_used_and_has_its_own_file():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        assert json.loads((bench.ROOT / c["file"]).read_text())["name"] \
            == c["name"]


def test_a_configuration_added_as_a_file_is_found(tmp_path):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    shutil.copytree(bench.PACKAGE / "traffic",
                    tmp_path / "portbench" / "traffic")
    spec = json.loads(json.dumps(SPEC))
    cfg = {"name": "g500-kron-s16", "generator": "kronecker", "scale": 16,
           "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}
    (tmp_path / "portbench" / "configs" / "g500-kron-s16.json").write_text(
        json.dumps(cfg))
    spec["configs"].append({"name": "g500-kron-s16", "source": "x",
                            "file": "portbench/configs/g500-kron-s16.json",
                            "reduced": ["scale"], "why": "x"})
    spec["workloads"].append({"name": "kron16.batch8",
                              "config": "g500-kron-s16",
                              "traffic": "batch8", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.cell("kron16.batch8", tmp_path)
    assert cell.config == cfg and cell.traffic["sources"] == 8
    # metrics without a workloads key reach the new cell by themselves
    assert [m.name for m in cell.end_to_end] == ["setup_s"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in bench.PACKAGE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import conftest, harness
for name in ("kron.batch8", "rand4.batch32", "kron.roots1"):
    res = harness.run(conftest.tiny_cell(name), 3, 0.2, True, device="cpu")
    assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = RUN_TINY.format(root=str(bench.ROOT),
                           src=str(bench.ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN


def test_without_the_port_a_run_prints_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "kron.batch8", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_without_a_card_a_run_prints_no_result():
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "kron.roots1", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, env=env,
                       cwd=bench.ROOT, timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout
