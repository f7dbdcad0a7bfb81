"""Architecture registry of the port (``repro/configs``).

The five LM architectures (kind ``"lm"``), xDeepFM (``xdeepfm``, kind
``"recsys"``), the four GNNs (``gat-cora``, ``pna``, ``dimenet``,
``nequip``, kind ``"gnn"``) and the paper's own engine (``sssp``, kind
``"sssp"``) register here: ``get_arch(name)`` / ``list_archs()`` resolve
an ``--arch`` id to its ``ArchSpec`` (full and smoke configs, the
dry-run shape names, and ``build_cell(cfg, shape) -> cells.Cell``, the
rank's step that ``launch/dryrun`` runs on a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str                       # lm | gnn | recsys | sssp
    full: object                    # full-size model config
    smoke: object                   # reduced config for CPU smoke tests
    shapes: tuple[str, ...]         # applicable dry-run cells
    # build_cell(cfg, shape_name) -> Cell (see configs.cells)
    build_cell: Callable
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # every module, whatever a caller imported first
    from repro_torch.configs import (  # noqa: F401
        command_r_35b, command_r_plus_104b, deepseek_moe_16b, dimenet,
        gat_cora, llama4_maverick_400b_a17b, nequip, pna, qwen3_32b,
        sssp_synth, xdeepfm)
