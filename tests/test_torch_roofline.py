"""The port's roofline (``repro_torch.launch.roofline``) and depth
calibration (``launch.calibrate``) on the CPU.

``RooflineTerms`` with the H100 constants; the counter on a known
product; collective bytes of real functional and ``torch.distributed``
collectives on a fake group, by the reference's output-shape convention
and against the numbers of ``tests/test_configs_and_roofline.py::
test_collective_parser``; the two-point fit at depth 6 against the
counted depth 6; and the least-work functions ``chip_smoke.py`` holds
the card to, at the values they had there."""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.configs import dimenet, gat_cora, nequip, pna
from repro_torch.configs.cells import lm_cell
from repro_torch.launch import calibrate, roofline as rl
from repro_torch.launch.mesh import init_fake_world, make_mesh
from test_torch_graph import _one_torch_thread  # noqa: F401


def test_terms_math_with_the_h100_constants():
    t = rl.RooflineTerms(flops=rl.PEAK_FLOPS, bytes_accessed=rl.HBM_BW,
                         collective_bytes=rl.INTER_NODE_BW, n_chips=256,
                         model_flops=0.5 * 256 * rl.PEAK_FLOPS)
    assert (t.t_compute, t.t_memory, t.t_collective, t.t_bound) == \
        (1.0, 1.0, 1.0, 1.0)
    assert t.roofline_fraction == 0.5
    assert t.useful_ratio == 0.5
    assert t.fits
    assert not dataclasses.replace(t, peak_bytes=81e9).fits
    t = dataclasses.replace(t, collective_s=3.0)
    assert t.bottleneck == "collective" and t.t_bound == 3.0
    d = t.to_dict()
    ref_keys = {"flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "chips", "model_flops",
                "raw_flops", "correction", "t_compute_s", "t_memory_s",
                "t_collective_s", "t_bound_s", "bottleneck", "useful_ratio",
                "roofline_fraction"}
    assert ref_keys | {"peak_bytes_per_chip", "fits"} == set(d)
    assert (rl.PEAK_FLOPS, rl.TF32_FLOPS, rl.FP32_FLOPS, rl.HBM_BW,
            rl.HBM_BYTES, rl.NVLINK_BW, rl.INTER_NODE_BW) == \
        (989e12, 495e12, 67e12, 3.35e12, 80e9, 450e9, 50e9)
    assert rl.link_bw(range(8)) == rl.NVLINK_BW
    assert rl.link_bw([0, 16]) == rl.INTER_NODE_BW


@pytest.mark.parametrize("fake", [False, True])
def test_counter_on_a_known_product(fake):
    m, k, n = 96, 64, 48

    def run():
        a = torch.ones(m, k)
        b = torch.ones(k, n)
        c = rl.WorkCounter()
        with c:
            out = a @ b
            v = out.t()                         # a view moves nothing
        return c, v
    if fake:
        with FakeTensorMode():
            c, _ = run()
    else:
        c, v = run()
        assert float(v[0, 0]) == k
    assert c.flops == 2 * m * n * k
    assert c.bytes == 4 * (m * k + k * n + m * n)
    assert c.peak == 4 * m * n
    assert c.coll["count"] == 0


def test_counter_sees_local_work_below_dtensor():
    with init_fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
        _local_work(mesh)


def _local_work(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    # propagation runs its ops on global shapes; emptied, its cache
    # cannot hide them, so the count below holds only if they are skipped
    ShardingPropagator._propagate_tensor_meta_cached.cache_clear()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 1024), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w1 = DTensor.from_local(torch.empty(1024, 256), mesh,
                                [Replicate(), Shard(1)], run_check=False)
        w2 = DTensor.from_local(torch.empty(256, 1024), mesh,
                                [Replicate(), Shard(0)], run_check=False)
        c = rl.WorkCounter()
        with c:
            y = (x @ w1).relu() @ w2
            y.redistribute(mesh, [Shard(0), Replicate()])
    # per rank: [8, 1024] @ [1024, 256] and [8, 256] @ [256, 1024]
    assert c.flops == 2 * (2 * 8 * 1024 * 256)
    assert c.coll["all-reduce"] == 8 * 1024 * 4
    assert c.coll["count"] == 1
    assert c.propagations > 0


def test_collective_bytes_by_the_reference_convention():
    """The reference's HLO sample: an all-gather to bf16[2048, 1024], an
    all-reduce of f32[128], a reduce-scatter to two f32[64, 32], an
    all-to-all of bf16[16, 512] and a permute of u32[8]."""
    import torch.distributed._functional_collectives as funcol
    with init_fake_world(4):
        group = dist.group.WORLD
        c = rl.WorkCounter()
        with c:
            outs = [funcol.all_gather_tensor(
                torch.empty(512, 1024, dtype=torch.bfloat16), 0, group),
                funcol.all_reduce(torch.empty(128), "sum", group)]
            outs += [funcol.reduce_scatter_tensor(torch.empty(256, 32), "sum",
                                                  0, group)
                     for _ in range(2)]
            outs.append(funcol.all_to_all_single(
                torch.empty(16, 512, dtype=torch.bfloat16), None, None,
                group))
            for t in outs:
                funcol.wait_tensor(t)
            dist.broadcast(torch.empty(8, dtype=torch.int32), 0)
        assert c.coll["all-gather"] == 2048 * 1024 * 2
        assert c.coll["all-reduce"] == 128 * 4
        assert c.coll["reduce-scatter"] == 2 * 64 * 32 * 4
        assert c.coll["all-to-all"] == 16 * 512 * 2
        assert c.coll["collective-permute"] == 8 * 4
        assert c.coll["count"] == 6
        # the same through torch.distributed's own calls
        c = rl.WorkCounter()
        with c:
            dist.all_gather_into_tensor(
                torch.empty(2048, 1024, dtype=torch.bfloat16),
                torch.empty(512, 1024, dtype=torch.bfloat16))
            dist.all_reduce(torch.empty(128))
            dist.reduce_scatter_tensor(torch.empty(64, 32),
                                       torch.empty(256, 32))
            dist.all_to_all_single(torch.empty(16, 512, dtype=torch.bfloat16),
                                   torch.empty(16, 512, dtype=torch.bfloat16))
        assert c.coll["all-gather"] == 2048 * 1024 * 2
        assert c.coll["all-reduce"] == 128 * 4
        assert c.coll["reduce-scatter"] == 64 * 32 * 4
        assert c.coll["all-to-all"] == 16 * 512 * 2
        # four ranks of one node: NVLink
        assert c.coll_s == pytest.approx(
            (2048 * 1024 * 2 + 512 + 64 * 32 * 4 + 16 * 512 * 2)
            / rl.NVLINK_BW)


def test_calibrated_fit_equals_the_counted_depth():
    cfg = get_arch("qwen3-32b").smoke
    with init_fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            fitted = calibrate.fit(
                *(calibrate.measure(lm_cell(dataclasses.replace(
                    cfg, n_layers=L), "train_4k", "qwen3-32b"), mesh)
                  for L in (2, 4)), 2, 4, 6)
            counted = calibrate.measure(lm_cell(dataclasses.replace(
                cfg, n_layers=6), "train_4k", "qwen3-32b"), mesh)
    for k in ("flops", "bytes", "coll"):
        assert fitted[k] == pytest.approx(counted[k], rel=1e-12), k
    assert fitted["coll_s"] == pytest.approx(counted["coll_s"], rel=1e-9)
    assert calibrate.depths(cfg) == (2, 4)
    assert calibrate.depths(get_arch("llama4-maverick-400b-a17b").full) == \
        (4, 8)


def test_least_work_values_unchanged():
    q = dataclasses.replace(get_arch("qwen3-32b").full, n_layers=4)
    d = dataclasses.replace(get_arch("deepseek-moe-16b").full, n_layers=2)
    assert rl.lm_work(q, 8, 1024) == ((5679493120, 32516759093248.0),
                                      (5595820032, 44727009280.0))
    assert rl.lm_work(d, 4, 256) == ((2793472000, 356549394432.0),
                                     (1405239296, 3072393216.0))
    assert rl.train_work(q, 4, 1024) == (68013038501888.0, 77136908288)
    assert rl.train_work(d, 4, 512) == (4723516112896.0, 35093442560)
    assert rl.gnn_work("gat-cora", gat_cora.FULL, 10556) == 32428032.0
    assert rl.gnn_work("pna", pna.cfg_for("minibatch_lg"), 168960) == \
        91238400000.0
    assert rl.gnn_work("dimenet", dimenet.FULL, 8192) == 77309411328.0
    assert rl.gnn_work("nequip", nequip.FULL, 8192) == 5607260160.0
    assert rl.bound(1e9, 1e12) == (14.925373134328359, "operations")
    assert rl.bound(1e6, 1e12, rl.PEAK_FLOPS) == (1.0111223458038423,
                                                  "operations")
