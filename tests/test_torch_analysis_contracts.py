"""The port's contract registry and signature audit
(``repro_torch.analysis.contracts``, ``trace_audit``): the decorator,
waiver expiry and matching and the most-specific budget, as the
reference's tests (``tests/test_analysis.py``) pin them; the port's
``REGISTRY`` holds the reference's spec names, each over the same route
patterns; the audit counts distinct signatures and explains a new one.
"""
import datetime

import pytest
import torch

from repro.analysis import check as ref_check
from repro.analysis.contracts import REGISTRY as REF_REGISTRY
from repro_torch.analysis import check
from repro_torch.analysis.contracts import (HOST_SYNC_OPS, KERNEL_ENTRIES,
                                            KNOWN_VIOLATIONS, REGISTRY,
                                            WIDE_DTYPES, ContractSpec,
                                            Waiver, contract, match_waiver)
from repro_torch.analysis.trace_audit import (TraceAudit, assert_no_retrace,
                                              signature_of, trace_counts)


def _registries():
    ref_check._import_governed_modules()
    check._import_governed_modules()
    return REF_REGISTRY, REGISTRY


def test_contract_decorator_registers_and_attaches():
    @contract("toy.decorated", routes=("toy.*",), require=("aten.add",))
    def toy():
        pass

    try:
        assert "toy.decorated" in REGISTRY
        assert toy.__contracts__[-1].name == "toy.decorated"
        assert REGISTRY["toy.decorated"].applies_to("toy.cold")
        assert not REGISTRY["toy.decorated"].applies_to("segment.cold")
    finally:
        del REGISTRY["toy.decorated"]


def test_waiver_expiry_and_matching():
    w = Waiver(route="a.*", rule="require:x", reason="r",
               expires="2000-01-01")
    assert w.expired()
    assert match_waiver("a.cold", "require:x", (w,)) is None  # expired
    live = Waiver(route="a.*", rule="require:x", reason="r",
                  expires="2999-01-01")
    assert match_waiver("a.cold", "require:x", (live,)) is live
    assert match_waiver("b.cold", "require:x", (live,)) is None
    today = datetime.date(1999, 1, 1)
    assert w.matches("a.cold", "require:x", today)  # not yet expired then


@pytest.mark.parametrize("field,method", [("dense_budget", "budget_for"),
                                          ("read_budget", "reads_for")])
def test_budget_most_specific_pattern_wins(field, method):
    spec = ContractSpec(name="b", routes=("x.*",),
                        **{field: {"x.warm": 11, "x.*": 8}})
    assert getattr(spec, method)("x.warm") == 11
    assert getattr(spec, method)("x.cold") == 8
    assert getattr(spec, method)("y.cold") is None
    assert getattr(ContractSpec(name="c", **{field: 3}), method)("y") == 3
    assert getattr(ContractSpec(name="d"), method)("x.cold") is None


SPEC_NAMES = [
    "backend.distributed", "backend.ell", "backend.frontier",
    "backend.pallas", "backend.segment", "bidi.pair_lanes",
    "engine.round_body", "fleet.frontier", "fleet.lockstep",
    "service.rides_solver_routes", "solver.targeted_early_exit",
    "warm.incremental_repair"]


def test_registry_has_the_reference_spec_names():
    ref, port = _registries()
    assert sorted(port) == sorted(ref) == SPEC_NAMES
    assert KNOWN_VIOLATIONS == ()


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_governs_the_reference_routes(name):
    """Each spec selects the reference's routes, but the targeted early
    exit: the port's untargeted solves pass no target, so only
    ``*.targeted`` routes read one in their predicate."""
    ref, port = _registries()
    r, p = ref[name], port[name]
    assert p.composes == r.composes
    if name == "solver.targeted_early_exit":
        assert p.routes == ("*.targeted",)
        assert p.require_cond == ("aten.gather",)
    else:
        assert p.routes == r.routes
    assert (p.dense_budget is None) == (r.dense_budget is None)


def test_vocabulary():
    """Host reads, wide dtypes and kernel entries as the gate names them:
    int64 is allowed (torch's index ops take it), every kernel entry maps
    to a launch key of ``kernels/_build``."""
    from repro_torch.kernels import _build
    assert "aten._local_scalar_dense" in HOST_SYNC_OPS
    assert "d2h_copy" in HOST_SYNC_OPS
    assert "float64" in WIDE_DTYPES and "int64" not in WIDE_DTYPES
    assert set(KERNEL_ENTRIES.values()) <= set(_build.LAUNCHES)
    assert REGISTRY["engine.round_body"].forbid == HOST_SYNC_OPS


# ---------------------------------------------------------------------------
# trace_audit
# ---------------------------------------------------------------------------

class _FakeSolver:
    def __init__(self):
        self.trace_count = 1
        self.warm_trace_count = 0


def test_trace_counts_both_conventions():
    fs = _FakeSolver()
    assert trace_counts(fs) == {"trace_count": 1, "warm_trace_count": 0}

    class Module:
        @staticmethod
        def trace_count():
            return 4
    assert trace_counts(Module) == {"trace_count": 4}
    assert trace_counts(object()) == {}


def test_assert_no_retrace_passes_and_fails():
    fs = _FakeSolver()
    with assert_no_retrace(fs):
        pass
    with pytest.raises(AssertionError, match="expected exactly 0"):
        with assert_no_retrace(fs):
            fs.trace_count += 1
    with assert_no_retrace(fs, allow=2):
        fs.trace_count += 1
        fs.warm_trace_count += 1
    with pytest.raises(ValueError, match="no trace counter"):
        with assert_no_retrace(object()):
            pass


def test_trace_audit_explains_a_new_signature():
    audit = TraceAudit("toy")
    assert audit.record(torch.zeros(4)) is True
    assert audit.record(torch.ones(4)) is False    # same shape and dtype
    assert audit.record(torch.zeros(8)) is True
    assert audit.record(torch.zeros(8, dtype=torch.int32)) is True
    assert audit.trace_count == audit.fresh_count == 3
    msg = audit.explain_last()
    assert "float32[8]@cpu" in msg and "int32[8]@cpu" in msg
    with assert_no_retrace(audit, allow=1):
        audit.record(torch.zeros(2, 2))


def test_trace_audit_wrap_records_calls():
    audit = TraceAudit("wrapped")
    f = audit.wrap(lambda x: x + 1)
    f(torch.ones(2))
    f(torch.ones(2))
    assert len(audit.calls) == 2 and audit.fresh_count == 1
    assert f.__trace_audit__ is audit


def test_signature_keys_strings_by_value():
    """Op sequences are recorded as strings: a value change is a new
    signature, where a Python int only keys by its type."""
    assert signature_of(("a", 1)) != signature_of(("b", 1))
    assert signature_of(("a", 1)) == signature_of(("a", 2))
