"""The port's serving launcher (``repro_torch.launch.serve_sssp``), run in
process on the CPU: ``main([... "--device", "cpu", "--verify"])``
returns 0, and for the same arguments (no ``--planner``, whose routes
follow the clocks) every counter it prints equals the reference
launcher's; only the timings and the port's ``device=`` field differ.
Without ``--device`` it asks for the card, and a wrong answer makes
``--verify`` return 1."""
import re
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve_sssp as rlaunch
from repro_torch.core.sssp import reference as pref
from repro_torch.launch import serve_sssp as plaunch
from test_torch_graph import _one_torch_thread  # noqa: F401

ARGS = [
    ["--family", "gnp", "--n", "300", "--queries", "32", "--batch", "4"],
    ["--family", "grid", "--n", "256", "--queries", "32", "--batch", "8",
     "--landmarks", "4", "--deltas", "1"],
    ["--family", "geometric", "--n", "200", "--queries", "24", "--batch",
     "4", "--landmarks", "3", "--bidirectional"],
    ["--family", "chain", "--n", "200", "--queries", "24", "--backend",
     "frontier", "--deltas", "2", "--delta-edges", "5"],
]


def _counters(text: str) -> list[str]:
    """The launcher's lines with the timings and the device field cut."""
    text = re.sub(r"\d+\.\d+s\b", "<t>s", text)
    text = re.sub(r"\(\d+\.\d+ queries/s\)", "(<q> queries/s)", text)
    text = text.replace("  device=cpu", "")
    return text.strip().splitlines()


@pytest.mark.parametrize("args", ARGS, ids=lambda a: a[1])
def test_launcher_counters_match_reference(args, capsys, monkeypatch):
    assert plaunch.main(args + ["--device", "cpu", "--verify"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve_sssp"] + args + ["--verify"])
    rlaunch.main()                      # the reference exits only on failure
    ref = capsys.readouterr().out
    assert _counters(port) == _counters(ref)
    assert "verified" in port and "OK" in port


def test_launcher_planner_verifies():
    assert plaunch.main(["--family", "geometric", "--n", "200", "--queries",
                         "32", "--batch", "4", "--landmarks", "3",
                         "--planner", "--bidirectional",
                         "--reselect-threshold", "0.5", "--deltas", "1",
                         "--device", "cpu", "--verify"]) == 0


def test_launcher_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plaunch.main(["--n", "100", "--queries", "4"])


def test_launcher_verify_fails_on_a_wrong_answer(monkeypatch, capsys):
    real = pref.dijkstra

    def off_by_one(g, source=0):
        res = real(g, source)
        res.dist = np.where(np.isfinite(res.dist), res.dist + 1.0, res.dist)
        return res
    monkeypatch.setattr(pref, "dijkstra", off_by_one)
    assert plaunch.main(["--n", "200", "--queries", "8", "--device", "cpu",
                         "--verify"]) == 1
    assert "MISMATCHES" in capsys.readouterr().out
