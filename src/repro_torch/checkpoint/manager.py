"""Checkpoint manager: keep-last-k, atomic writes, restore of the latest
(port of ``repro/checkpoint/manager.py``).

``save`` snapshots the tree to the host at once, so the caller may go on
mutating its tensors, and writes ``<dir>/tmp_step_N`` (on a background
thread unless ``blocking``), renamed to ``<dir>/step_N`` only when
complete: a crash mid-write leaves no partial ``step_N``, and
``restore_latest`` never reads a ``tmp_step_*``.
"""
from __future__ import annotations

import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.checkpoint.store import load_pytree, map_leaves, save_pytree


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


class CheckpointManager:
    """Numbered checkpoints of one tree in ``directory``, the last
    ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Checkpoint ``tree`` as step ``step``; one write in flight at a
        time."""
        self.wait()
        tree = map_leaves(_host_copy, tree)

        def write():
            tmp = os.path.join(self.dir, f"tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            save_pytree(tree, tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:   # handed to the caller by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight is done; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def steps(self) -> list[int]:
        """The complete checkpoints' steps, ascending."""
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, tree_like):
        """``(step, tree)`` of the newest complete checkpoint, in
        ``tree_like``'s structure, or ``(None, None)``."""
        self.wait()
        steps = self.steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, load_pytree(tree_like,
                                 os.path.join(self.dir, f"step_{step}"))

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
