"""The paper's own architecture: the distributed SSSP engine (port of
``repro/configs/sssp_synth.py``).

Two dry-run cells beyond the assigned 36 show that the paper's technique
itself shards to the production mesh:

  sssp_web_64m  — n=4M vertices, e=64M edges (web-graph scale): edges
                  sharded over the data axes, vertex vectors replicated,
                  MIN all-reduces per round.
  sssp_road_16m — n=16M vertices, e=48M edges (road network: high
                  diameter, many rounds — the worst case for
                  bulk-synchronous SSSP).

A cell is ONE SP4 round of a rank's program
(``core/sssp/distributed.round_program``): the round count depends on
the data, and a fake tensor cannot be read on the host, so the dry-run
prices a round (the reference's per-round terms too).  The graph is
made of ``torch.empty`` tensors: under the dry-run's fake-tensor mode no
64M-edge graph is materialized.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import Cell, Step
from repro_torch.core.graph import Graph, round_up
from repro_torch.core.sssp.engine import SP4_CONFIG, SSSPConfig

SHAPES = {
    "sssp_web_64m": dict(n=4_000_000, e=64_000_000, max_rounds=512),
    "sssp_road_16m": dict(n=16_000_000, e=48_000_000, max_rounds=4096),
}

FULL = SP4_CONFIG
SMOKE = SSSPConfig(max_rounds=64)


def abstract_graph(n: int, e: int, n_shards: int) -> Graph:
    """A dst-sorted graph's tensors of ``n`` vertices and ``e`` edges,
    padded as ``shard_graph_edges`` pads for ``n_shards`` (values
    unset)."""
    e_pad = round_up(e, n_shards * 128)
    i32, f32 = torch.int32, torch.float32
    return Graph(n=n, e=e, e_pad=e_pad,
                 src=torch.empty(e_pad, dtype=i32),
                 dst=torch.empty(e_pad, dtype=i32),
                 w=torch.empty(e_pad, dtype=f32),
                 in_deg=torch.empty(n, dtype=i32),
                 out_deg=torch.empty(n, dtype=i32),
                 in_weight=torch.empty(n, dtype=f32),
                 out_weight=torch.empty(n, dtype=f32))


def build_cell(cfg: SSSPConfig, shape: str) -> Cell:
    info = SHAPES[shape]
    n, e = info["n"], info["e"]

    def build(mesh) -> Step:
        import dataclasses
        from repro_torch.core.sssp.distributed import (edge_group,
                                                       round_program)
        group, n_shards = edge_group(mesh)
        g = abstract_graph(n, e, n_shards)
        run_cfg = dataclasses.replace(cfg, max_rounds=info["max_rounds"])
        run, inputs, _ = round_program(g, group, 0, run_cfg)
        return Step(run, inputs)

    # per round: ~4 segment ops over e edges (~6 flops each)
    return Cell(arch="sssp", shape=shape, kind="sssp", build=build,
                model_flops=6.0 * e * 4, tokens=n,
                notes="paper-core distributed cell, one round")


ARCH = register(ArchSpec(
    name="sssp", kind="sssp", full=FULL, smoke=SMOKE,
    shapes=tuple(SHAPES), build_cell=build_cell,
    notes="the paper's engine on the production mesh",
))
