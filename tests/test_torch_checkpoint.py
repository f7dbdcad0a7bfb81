"""Port parity for on-disk checkpoints (``repro_torch.checkpoint``): a
round trip of nested trees with bf16 leaves; keep-last-k; atomic writes
(no ``tmp_step_*`` left, none restored); the reference's on-disk format
both ways (the port loads what ``repro.checkpoint`` wrote and the
reverse); and the congestion replay's dropout restart from disk,
bitwise the fault-free replay and the reference's on-disk replay at the
same seed (the counterpart of the reference's on-disk replay test)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.checkpoint import load_pytree as rload
from repro.checkpoint import save_pytree as rsave
from repro.core import generators as rgen
from repro.core.sssp.fleet import FleetSolver as RFleetSolver
from repro.core.sssp.fleet import build_fleet as rbuild_fleet
from repro.distributed import fault as rfault
from repro.runtime import fleet as rreplay
import repro_torch.sssp as P
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.core import generators as pgen
from repro_torch.distributed import fault as pfault
from repro_torch.runtime import fleet as preplay
from test_torch_graph import _one_torch_thread  # noqa: F401


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 3, generator=g),
            "emb": torch.randn(5, generator=g).to(torch.bfloat16),
            "opt": [torch.arange(6, dtype=torch.int32),
                    (np.float32(0.5), np.arange(3, dtype=np.int64))],
            "mask": torch.tensor([True, False]),
            "step": 7, "none": None}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if a is None:
        return b is None
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    b = np.asarray(b)
    return np.asarray(a).dtype == b.dtype and np.array_equal(a, b)


def test_round_trip_with_bf16(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path))
    back = load_pytree(_tree(), str(tmp_path))
    assert _equal(tree, back)
    with open(tmp_path / "manifest.json") as f:
        specs = json.load(f)["leaves"]
    # JAX's leaf order: dict keys sorted, sequences in order, None empty
    assert [s["path"] for s in specs] == ["emb", "mask", "opt/0", "opt/1/0",
                                          "opt/1/1", "step", "w"]
    assert specs[0]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="leaf count"):
        load_pytree({"w": torch.zeros(1)}, str(tmp_path))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path))
    like = {"w": jnp.zeros((4, 3)), "emb": jnp.zeros(5, jnp.bfloat16),
            "opt": [jnp.zeros(6, jnp.int32), (0.0, np.zeros(3))],
            "mask": jnp.zeros(2, bool), "step": 0, "none": None}
    back = rload(like, str(tmp_path))
    assert np.array_equal(np.asarray(back["w"]), tree["w"].numpy())
    assert np.array_equal(np.asarray(back["emb"], np.float32),
                          tree["emb"].float().numpy())
    assert np.asarray(back["emb"]).dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["opt"][0]), np.arange(6))
    assert float(back["opt"][1][0]) == 0.5
    assert np.array_equal(np.asarray(back["mask"]), [True, False])


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    ref = {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
           "emb": jnp.linspace(0, 1, 5).astype(jnp.bfloat16),
           "opt": [jnp.ones(2, jnp.int32), (jnp.float32(2.5),)]}
    rsave(ref, str(tmp_path))
    like = {"w": torch.zeros(3, 4), "emb": torch.zeros(5),
            "opt": [np.zeros(2), (np.float32(0),)]}
    back = load_pytree(like, str(tmp_path))
    assert torch.equal(back["w"], torch.arange(12.0).reshape(3, 4))
    assert back["emb"].dtype == torch.bfloat16
    assert torch.equal(back["emb"].float(), torch.from_numpy(
        np.asarray(ref["emb"], np.float32)))
    assert isinstance(back["opt"][0], np.ndarray)
    assert back["opt"][0].dtype == np.int32 and back["opt"][1] == (2.5,)


def test_keep_last_k_and_atomic_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        tree["w"] = tree["w"] + 1.0
        mgr.save(step, tree)                 # on the background thread
    mgr.wait()
    assert mgr.steps() == [2, 3]
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp_")]
    # a write cut short leaves only a tmp dir, which restore skips
    os.makedirs(tmp_path / "tmp_step_9")
    step, back = mgr.restore_latest(_tree())
    assert step == 3 and _equal(back["w"], tree["w"])
    # the snapshot is taken at save(): later in-place edits do not leak
    snap = tree["w"].clone()
    mgr.save(4, tree)
    tree["w"].add_(100.0)
    _, back = mgr.restore_latest(_tree())
    assert torch.equal(back["w"], snap)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        _tree()) == (None, None)


def test_a_failed_write_raises_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"bad": np.array([object()])})
    with pytest.raises(ValueError):
        mgr.wait()
    assert mgr.steps() == []


REPLAY = dict(seed=5, ckpt_every=2, queries_per_tick=4, straggler_z=1.2)
NOISY = ("straggler_sleep_s", "drift_s", "query_s", "stragglers_flagged")


def _replay(fault, manager=None, ticks=6):
    fleet = P.build_fleet([pgen.make("geometric", 100, seed=s)
                           for s in range(4)], device="cpu")
    rp = preplay.CongestionReplay(P.FleetSolver(fleet), fault=fault,
                                  manager=manager, **REPLAY)
    return rp, rp.run(ticks)


def _ref_replay(fault, manager, ticks=6):
    fleet = rbuild_fleet([rgen.make("geometric", 100, seed=s)
                          for s in range(4)])
    rp = rreplay.CongestionReplay(RFleetSolver(fleet), fault=fault,
                                  manager=manager, **REPLAY)
    return rp, rp.run(ticks)


def _quiet(stats):
    return {k: v for k, v in stats.items() if k not in NOISY}


def test_dropout_restart_bitwise_on_disk(tmp_path):
    """The port's on-disk dropout restart equals its fault-free replay and
    the reference's on-disk replay at the same seed and fault (weights,
    distances, stats, kept steps, the files of the last checkpoint)."""
    clean, _ = _replay(None)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    chaos, st = _replay(pfault.FaultInjector({3: ("dropout", 0)}), mgr)
    rmgr = RCheckpointManager(str(tmp_path / "ref"), keep=2)
    ref, rst = _ref_replay(rfault.FaultInjector({3: ("dropout", 0)}), rmgr)
    assert st["restarts"] == 1 and st["ticks"] == 7
    assert np.array_equal(clean.weights(), chaos.weights())
    assert np.array_equal(clean.distances(), chaos.distances())
    assert np.array_equal(np.asarray(ref.weights()), chaos.weights())
    assert np.array_equal(np.asarray(ref.distances()), chaos.distances())
    assert _quiet(rst) == _quiet(st)
    assert mgr.steps() == rmgr.steps() == [5, 7]   # step tick + 1, keep 2
    _, state = mgr.restore_latest(chaos._state())
    assert int(state["tick"]) == 6
    assert torch.equal(state["w"], chaos.solver.state_dict()["w"])
    # the two packages wrote the same checkpoint, leaf for leaf
    rstate = load_pytree(chaos._state(), os.path.join(rmgr.dir, "step_7"))
    assert _equal(rstate, state)
