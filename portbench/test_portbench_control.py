"""The control at a size the CPU holds: for every cell, on three seeds, a
whole run with the bfloat16 reference in the program's place comes out
not correct by the number a run compares, and the same run with the
port comes out correct."""
import pytest

from portbench import control, harness

CELLS = ("kron.batch8", "rand4.batch32", "kron.roots1")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name, tiny):
    cell = tiny(name)
    for seed in (11, 2**31 + 12, 13):
        res = control.run(cell, seed, 0.3, "cpu")
        assert res["correct"] is False, res["checks"]
        assert res["checks"]["mismatched_distances"]["value"] > 0
        assert res["checks"]["checked_lanes"]["value"] >= 1
        res = harness.run(cell, seed, 0.3, False, device="cpu")
        assert res["correct"] is True, res["checks"]


def test_the_control_leaves_the_harness_as_it_was(tiny):
    from portbench import traffic as mix
    made, sent = harness.make_inputs, mix.send
    with control.in_programs_place():
        assert (harness.make_inputs, mix.send) != (made, sent)
    assert (harness.make_inputs, mix.send) == (made, sent)
