"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: the
cell matrix as the reference's (``tests/test_configs_and_roofline.py``),
every cell's analytic model FLOPs equal to the reference's
``build_cell(...).model_flops``, ``run_cell`` at smoke configs on fake
(2, 2) and (2, 2, 2) meshes for one cell of each kind (LM train, prefill
and decode, GNN, recsys, sssp), the record's keys and ``report``'s
tables."""
import importlib

import pytest

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import dryrun, report
from test_torch_graph import _one_torch_thread  # noqa: F401

def ref_get_arch(name: str):
    """The reference's ``ArchSpec`` from its config module (the
    reference's registry loads its archs only while it is empty, so
    another test file's partial registration could hide them)."""
    mod = "sssp_synth" if name == "sssp" else name.replace("-", "_")
    return importlib.import_module("repro.configs." + mod).ARCH


ASSIGNED = [
    "deepseek-moe-16b", "llama4-maverick-400b-a17b", "command-r-35b",
    "command-r-plus-104b", "qwen3-32b",
    "nequip", "pna", "gat-cora", "dimenet", "xdeepfm",
]
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "chips", "kind",
               "roofline", "argument_size_in_bytes", "peak_size_in_bytes",
               "collectives", "run_s", "status"}


def test_cell_matrix_counts():
    """36 runnable assigned cells (4 long_500k skips) + 2 SSSP cells."""
    assert set(ASSIGNED + ["sssp"]) == set(list_archs())
    runnable = sum(len(get_arch(a).shapes) for a in ASSIGNED)
    assert runnable == 36
    skipped = sum(1 for a in ASSIGNED
                  if get_arch(a).kind == "lm"
                  and "long_500k" not in get_arch(a).shapes)
    assert skipped == 4
    assert len(get_arch("sssp").shapes) == 2
    assert len(dryrun.cells_for(None, None, True)) == 38
    for a in list_archs():
        assert get_arch(a).shapes == ref_get_arch(a).shapes, a


@pytest.mark.parametrize("arch", ASSIGNED + ["sssp"])
def test_model_flops_equal_the_reference(arch):
    spec, ref = get_arch(arch), ref_get_arch(arch)
    for shape in spec.shapes:
        got = spec.build_cell(spec.full, shape)
        want = ref.build_cell(ref.full, shape)
        assert got.model_flops == want.model_flops, (arch, shape)
        assert (got.kind, got.tokens) == (want.kind, want.tokens), shape


SMOKE_CELLS = [
    ("qwen3-32b", "train_4k", "train"),
    ("deepseek-moe-16b", "prefill_32k", "prefill"),
    ("llama4-maverick-400b-a17b", "decode_32k", "decode"),
    ("gat-cora", "full_graph_sm", "train"),
    ("xdeepfm", "serve_p99", "serve"),
    ("sssp", "sssp_web_64m", "sssp"),
]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch,shape,kind", SMOKE_CELLS)
def test_run_cell_on_fake_meshes(arch, shape, kind, mesh_shape, tmp_path):
    spec = get_arch(arch)
    # the depth fit on the small mesh only (the file's time limit)
    cal = len(mesh_shape) == 2
    rec = dryrun.run_cell(arch, shape, len(mesh_shape) == 3, str(tmp_path),
                          verbose=False, calibrate=cal, cfg=spec.smoke,
                          mesh_shape=mesh_shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    assert rec["kind"] == kind
    assert rec["chips"] == (4 if len(mesh_shape) == 2 else 8)
    ro = rec["roofline"]
    assert ro["bytes_per_chip"] > 0 and ro["peak_bytes_per_chip"] > 0
    assert rec["argument_size_in_bytes"] > 0
    if kind in ("train", "prefill", "decode", "serve"):
        assert ro["flops_per_chip"] > 0
    if kind != "serve":                         # serving is data-parallel
        assert ro["collective_bytes_per_chip"] > 0
    if arch == "qwen3-32b" and cal:
        assert ro["correction"] == "two-point-depth"
        assert rec["calibration"]["depths"] == [2, 4]
    recs = report.load(str(tmp_path))
    assert [r["arch"] for r in recs] == [arch]
    table = report.dryrun_table(recs)
    assert f"| {arch} | {shape} |" in table
    assert report.roofline_table(recs, rec["mesh"]).count("\n") == 2
    import torch.distributed as dist
    assert not dist.is_initialized()            # the fake group is gone


def test_a_failing_cell_is_recorded(tmp_path, monkeypatch):
    from repro_torch.configs import cells

    def boom(cfg):
        raise ValueError("no parameters on purpose")
    monkeypatch.setattr(cells, "lm_param_shapes", boom)
    rec = dryrun.run_cell("qwen3-32b", "decode_32k", False, str(tmp_path),
                          verbose=False, cfg=get_arch("qwen3-32b").smoke,
                          mesh_shape=(2, 2))
    assert rec["status"] == "fail" and "on purpose" in rec["error"]
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(KeyError):               # as the reference's
        dryrun.run_cell("qwen3-32b", "no_such_shape", False, None)


def test_report_lists_failures(tmp_path, capsys):
    import json
    ok = {"arch": "a", "shape": "s", "mesh": "single", "status": "ok",
          "roofline": {"t_compute_s": 1.0, "t_memory_s": 2.0,
                       "t_collective_s": 0.5, "bottleneck": "memory",
                       "model_flops": 1e15, "useful_ratio": 0.5,
                       "roofline_fraction": 0.25, "fits": False,
                       "flops_per_chip": 2e12,
                       "collective_bytes_per_chip": 3e9}}
    bad = {"arch": "b", "shape": "s", "mesh": "multi", "status": "fail",
           "error": "ValueError: boom"}
    for i, r in enumerate((ok, bad)):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.main(["--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "(1 ok / 1 failed)" in out
    assert "| a | s | 1.0000s | 2.0000s | 0.5000s | **memory** |" in out
    assert "- b s multi: ValueError: boom" in out
    assert "| no |" in out
