"""Signature audit: count distinct call signatures, explain a new one
(port of ``repro/analysis/trace_audit.py``).

The reference counts XLA traces; the port runs eagerly and its facades
keep no ``trace_count`` (they count ``solves``).  What stays useful is
the vocabulary:

  * :func:`trace_counts` reads every counter an object exposes
    (``trace_count``, ``warm_trace_count``), whatever its convention;
  * :func:`assert_no_retrace` is the pytest helper: a block performs
    exactly ``allow`` new traces across any mix of counter-bearing
    objects (a :class:`TraceAudit` is one);
  * :class:`TraceAudit` records the signature of every call (pytree
    structure and, per tensor leaf, shape, dtype and device; the repr of
    any other leaf) and *explains* a new one: which leaf changed.
    ``trace_count`` is the number of distinct signatures it has seen.

The gate records each round's op sequence in a ``TraceAudit``: a dense
route must issue one sequence with one set of shapes for every source
and every round on a graph, the eager counterpart of "one program a
shape" (what a CUDA graph captured over a round will need).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from contextlib import contextmanager
from typing import Any, Callable

_COUNTER_NAMES = ("trace_count", "warm_trace_count")


def trace_counts(obj: Any) -> dict[str, int]:
    """Read every trace counter ``obj`` exposes: integer attributes or
    zero-arg callables.  Returns ``{counter_name: value}``; empty dict if
    ``obj`` has none."""
    counts: dict[str, int] = {}
    for name in _COUNTER_NAMES:
        val = getattr(obj, name, None)
        if val is None:
            continue
        if callable(val):
            try:
                if inspect.signature(val).parameters:
                    continue  # not a 0-arg counter
            except (TypeError, ValueError):
                continue
            val = val()
        if isinstance(val, int) and not isinstance(val, bool):
            counts[name] = val
    return counts


def _label(obj: Any) -> str:
    return getattr(obj, "__name__", getattr(obj, "name",
                                            type(obj).__name__))


@contextmanager
def assert_no_retrace(*objs: Any, allow: int = 0):
    """Assert a with-block performs exactly ``allow`` new traces, summed
    over every counter of ``objs``; ``AssertionError`` with a per-object
    breakdown otherwise."""
    if not objs:
        raise ValueError("assert_no_retrace needs at least one object "
                         "exposing a trace counter")
    before = [trace_counts(o) for o in objs]
    for o, b in zip(objs, before):
        if not b:
            raise ValueError(
                f"{_label(o)} exposes no trace counter "
                f"({'/'.join(_COUNTER_NAMES)}) — nothing to audit")
    yield
    after = [trace_counts(o) for o in objs]
    deltas = {
        f"{_label(o)}.{name}": a[name] - b.get(name, 0)
        for o, b, a in zip(objs, before, after)
        for name in a
    }
    total = sum(deltas.values())
    assert total == allow, (
        f"expected exactly {allow} new trace(s), got {total}: "
        + ", ".join(f"{k}+{v}" for k, v in deltas.items() if v)
        + (" (no counter moved)" if total == 0 else ""))


# --------------------------------------------------------------------
# Signature recording
# --------------------------------------------------------------------

def _leaf_key(x: Any) -> tuple:
    """The part of one leaf a signature keys on: shape, dtype and device
    of a tensor, the type of a Python scalar, the repr of anything else."""
    import torch
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype).replace("torch.", ""),
                x.device.type)
    if isinstance(x, (bool, int, float, complex)):
        return ("scalar", type(x).__name__)
    return ("static", repr(x))


def signature_of(*args, **kwargs) -> tuple:
    """Signature of a call: treespec + per-leaf keys."""
    import torch.utils._pytree as pytree
    leaves, spec = pytree.tree_flatten((args, kwargs))
    return (str(spec), tuple(_leaf_key(x) for x in leaves))


def _diff(sig_a: tuple, sig_b: tuple, *, paths_a, paths_b) -> list[str]:
    out: list[str] = []
    if sig_a[0] != sig_b[0]:
        out.append(f"pytree structure changed: {sig_a[0]} -> {sig_b[0]}")
    pairs = zip(paths_a, sig_a[1], paths_b, sig_b[1])
    for path_a, key_a, path_b, key_b in pairs:
        if key_a != key_b:
            out.append(f"{path_a or path_b}: {_fmt(key_a)} -> {_fmt(key_b)}")
    if len(sig_a[1]) != len(sig_b[1]):
        out.append(f"leaf count changed: {len(sig_a[1])} -> "
                   f"{len(sig_b[1])}")
    return out


def _fmt(key: tuple) -> str:
    if key[0] == "tensor":
        _, shape, dtype, device = key
        return f"{dtype}{list(shape)}@{device}"
    if key[0] == "scalar":
        return f"py {key[1]}"
    return key[1]


@dataclasses.dataclass
class CallRecord:
    """One recorded call: signature + whether it was new."""

    signature: tuple
    paths: tuple[str, ...]
    fresh: bool


class TraceAudit:
    """Record call signatures and explain why a new one appeared.

    Use as a passive recorder (``audit.record(*args)``) or wrap a
    callable once (``fn = audit.wrap(fn)``).  ``trace_count`` (and its
    alias ``fresh_count``) is the number of distinct signatures seen;
    :meth:`explain_last` names which leaf of the newest distinct
    signature differs from the one before it.
    """

    def __init__(self, name: str = "call"):
        self.name = name
        self.calls: list[CallRecord] = []
        self._seen: set[tuple] = set()

    @property
    def fresh_count(self) -> int:
        return sum(1 for c in self.calls if c.fresh)

    trace_count = fresh_count

    def record(self, *args, **kwargs) -> bool:
        """Record one call; returns True iff its signature is new."""
        import torch.utils._pytree as pytree
        sig = signature_of(*args, **kwargs)
        flat, _ = pytree.tree_flatten_with_path((args, kwargs))
        paths = tuple(pytree.keystr(p) for p, _ in flat)
        fresh = sig not in self._seen
        self._seen.add(sig)
        self.calls.append(CallRecord(sig, paths, fresh))
        return fresh

    def wrap(self, fn: Callable) -> Callable:
        """Return ``fn`` with every call recorded by this audit."""

        @functools.wraps(fn)
        def audited(*args, **kwargs):
            self.record(*args, **kwargs)
            return fn(*args, **kwargs)

        audited.__trace_audit__ = self
        return audited

    def explain_last(self) -> str:
        """Explain the most recent *fresh* call against its predecessor."""
        fresh_idx = [i for i, c in enumerate(self.calls) if c.fresh]
        if not fresh_idx:
            return f"{self.name}: no calls recorded"
        last = self.calls[fresh_idx[-1]]
        prev_idx = [i for i in fresh_idx if i < fresh_idx[-1]]
        if not prev_idx:
            return (f"{self.name}: first call — initial signature, "
                    "nothing to compare")
        prev = self.calls[prev_idx[-1]]
        diffs = _diff(prev.signature, last.signature,
                      paths_a=prev.paths, paths_b=last.paths)
        if not diffs:
            return f"{self.name}: signatures identical (no cause)"
        return (f"{self.name}: new signature caused by:\n  "
                + "\n  ".join(diffs))

    def to_json(self) -> dict:
        return dict(name=self.name, calls=len(self.calls),
                    fresh=self.fresh_count)
