"""Model configurations of the port (``repro/configs``).

The five LM architectures (kind ``"lm"``), xDeepFM (``xdeepfm``, kind
``"recsys"``) and the four GNNs (``gat-cora``, ``pna``, ``dimenet``,
``nequip``, kind ``"gnn"``; their shape table in ``cells``) register
here: ``get_arch(name)`` / ``list_archs()``
resolve an ``--arch`` id to its ``ArchSpec`` (full and smoke configs,
the reference's dry-run shape names).  The reference's ``build_cell``
(an XLA lowering of a dry-run cell) has no counterpart.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str                       # lm | recsys | gnn
    full: object                    # full-size model config
    smoke: object                   # reduced config for CPU smoke tests
    shapes: tuple[str, ...]         # the reference's dry-run cell names
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


def lm_shapes_for(cfg) -> tuple[str, ...]:
    """The reference's dry-run cells of an LM (``configs/cells.py``):
    ``long_500k`` only for sub-quadratic attention."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return tuple(shapes)


def _ensure_loaded() -> None:
    # every module, whatever a caller imported first
    from repro_torch.configs import (  # noqa: F401
        command_r_35b, command_r_plus_104b, deepseek_moe_16b, dimenet,
        gat_cora, llama4_maverick_400b_a17b, nequip, pna, qwen3_32b,
        xdeepfm)
