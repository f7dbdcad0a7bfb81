"""Program checks of the port's solver routes: contracts, op lint,
signature audit, AST rules (port of ``repro/analysis``).

The port's routes (four backends, warm re-solve, the distributed,
bidirectional and fleet paths) are bitwise-equivalent realizations of
one round body.  What makes that hold and keeps it fast (no quiet fall
back to a dense or plain path, no uncounted host read in a round, one op
sequence a dense round, f32/i32 values) is a property of what the rounds
execute, which output tests can only spot-check.  This package checks
it:

  contracts     the ``@contract`` registry: invariants declared next to
                the code they govern, plus the KNOWN_VIOLATIONS waivers.
  op_lint       records the ops every route executes (a
                ``TorchDispatchMode`` and scope wrappers) and verdicts it
                against the declared contracts (``jaxpr_lint``'s
                counterpart).
  routes        runs every solver route on the probe graph.
  trace_audit   signature audit: distinct call signatures, explained;
                the ``assert_no_retrace`` pytest helper.
  astlint       repo-specific AST rules over the round scopes.
  check         the CLI gate: ``python -m repro_torch.analysis.check
                --ci [--device cpu|cuda]``.
"""
from repro_torch.analysis.contracts import (KNOWN_VIOLATIONS, REGISTRY,
                                            ContractSpec, Waiver, contract)
from repro_torch.analysis.op_lint import (LintReport, Recorder,
                                          RouteVerdict, lint_route)
from repro_torch.analysis.trace_audit import (TraceAudit, assert_no_retrace,
                                              trace_counts)

__all__ = [
    "ContractSpec", "Waiver", "contract", "REGISTRY", "KNOWN_VIOLATIONS",
    "LintReport", "RouteVerdict", "lint_route", "Recorder",
    "TraceAudit", "assert_no_retrace", "trace_counts",
]
