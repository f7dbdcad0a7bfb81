"""Multi-pod dry-run driver (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell and both production meshes,
in ONE process on torch's ``fake`` process group (256 or 512 ranks, of
which this process is rank 0; no collective executes) and under a
``FakeTensorMode`` (no tensor holds memory, no device is touched):

    cell.build(mesh)       # parameters, state and batch as DTensors
                           # placed by the sharding rules
    WorkCounter            # rank 0's program run once, counted below
                           # DTensor: FLOPs, bytes, collective bytes,
                           # peak live bytes

and the roofline terms on an H100 (``launch/roofline``).  LM train and
prefill cells are priced from two shallow depths (``launch/calibrate``).
Results land in ``experiments/dryrun_torch/<cell>.json``; ``python -m
repro_torch.launch.report`` tabulates them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sssp --shape sssp_web_64m

The fake group is torn down after every cell: a process that solves on
the default process group afterwards sees none.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

OUT_DIR = "experiments/dryrun_torch"


def _mesh_axes(shape) -> tuple[str, ...]:
    return ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")


def run_cell(arch_name: str, shape: str, multi_pod: bool,
             out_dir: str | None, verbose: bool = True,
             calibrate: bool = True, *, cfg=None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell on one mesh: the record (also written to ``out_dir``).
    ``cfg`` replaces the arch's full config and ``mesh_shape`` the
    production mesh (smoke runs on small fake worlds)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import (init_fake_world, make_mesh,
                                         make_production_mesh)

    spec = get_arch(arch_name)
    cfg = spec.full if cfg is None else cfg
    cell = spec.build_cell(cfg, shape)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    n_chips = math.prod(mesh_shape)
    mesh_name = "multi" if len(mesh_shape) == 3 else "single"
    tag = f"{arch_name}__{shape}__{mesh_name}"
    rec: dict = {"arch": arch_name, "shape": shape, "mesh": mesh_name,
                 "mesh_shape": list(mesh_shape), "chips": n_chips,
                 "kind": cell.kind}
    t0 = time.time()
    try:
        with init_fake_world(n_chips):
            if mesh_shape in ((16, 16), (2, 16, 16)):
                mesh = make_production_mesh(
                    multi_pod=len(mesh_shape) == 3, device_type="cpu")
            else:
                mesh = make_mesh(mesh_shape, _mesh_axes(mesh_shape),
                                 device_type="cpu")
            rec.update(_counted(spec, cell, cfg, shape, arch_name, mesh,
                                n_chips, calibrate))
        rec["run_s"] = round(time.time() - t0, 1)
        rec["status"] = "ok"
        if verbose:
            r = rec["roofline"]
            print(f"[OK ] {tag:55s} {rec['run_s']:6.1f}s "
                  f"flops/chip {r['flops_per_chip']:.3e} "
                  f"coll/chip {r['collective_bytes_per_chip']:.3e}B "
                  f"peak/chip {r['peak_bytes_per_chip']:.3e}B "
                  f"-> {r['bottleneck']} "
                  f"(frac {r['roofline_fraction']:.2f}"
                  f"{'' if r['fits'] else ', does not fit 80 GB'})",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {tag}: {rec['error'][:200]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def _counted(spec, cell, cfg, shape, arch_name, mesh, n_chips: int,
             calibrate: bool) -> dict:
    """The record's counted fields of ``cell`` on ``mesh``, under a
    fake-tensor mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.calibrate import lm_calibration
    from repro_torch.launch.roofline import WorkCounter, terms_from_counter
    rec: dict = {}
    with FakeTensorMode():
        step = cell.build(mesh)
        counter = WorkCounter()
        counter.track(step.inputs)
        cal = None
        if (calibrate and spec.kind == "lm"
                and cell.kind in ("train", "prefill")):
            # the full-depth inputs give the argument bytes; the run is
            # priced from two depths
            del step
            cal = lm_calibration(cfg, shape, arch_name, mesh)
            rec["calibration"] = {
                k: cal[k] for k in
                ("flops", "bytes", "coll", "coll_s", "peak",
                 "flops_per_layer", "flops_nonscan", "depths")}
            peak = cal["peak"]
        else:
            with counter:
                step.run()
            del step
            peak = counter.peak
        rec["argument_size_in_bytes"] = int(counter.args_bytes)
        rec["peak_size_in_bytes"] = int(peak)
        terms = terms_from_counter(counter, n_chips,
                                   model_flops=cell.model_flops,
                                   calibration=cal, peak_bytes=peak)
        rec["collectives"] = dict(counter.coll)
        rec["roofline"] = terms.to_dict()
    return rec


def quiet_dtensor() -> None:
    """Silence DTensor's per-redistribution advice (two all-reduces over a
    2-d mesh, the CPU mesh's all-to-all emulation) in the sweep's log."""
    import logging
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._collective_utils"):
        logging.getLogger(name).setLevel(logging.ERROR)


def cells_for(arch: str | None, shape: str | None, all_cells: bool):
    from repro_torch.configs import get_arch, list_archs
    if all_cells:
        return [(a, s) for a in list_archs() for s in get_arch(a).shapes]
    if not arch:
        raise SystemExit("--arch or --all required")
    spec = get_arch(arch)
    return [(arch, s) for s in ([shape] if shape else spec.shapes)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    quiet_dtensor()
    cells = cells_for(args.arch, args.shape, args.all)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    t0 = time.time()
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out)
            if rec["status"] == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, "
          f"{time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
