"""The benchmark's CPU tests: the port under ``src`` is importable, and
``tiny(name)`` is a cell of ``BENCHMARK.json`` with its graph cut to a
size the CPU holds (widths, weights and traffic as they are)."""
import dataclasses
import sys

import pytest

from portbench import bench

SRC = str(bench.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# scale keys of each generator, set to sizes a test holds
TINY = {"kronecker": {"scale": 8}, "sprand": {"n": 512, "length_max": 512}}


def tiny_cell(name: str) -> bench.Cell:
    c = bench.cell(name)
    return dataclasses.replace(
        c, config={**c.config, **TINY[c.config["generator"]]})


@pytest.fixture
def tiny():
    return tiny_cell
