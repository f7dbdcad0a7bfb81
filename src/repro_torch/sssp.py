"""``repro_torch.sssp`` — the public SSSP surface of the port.

    from repro_torch import sssp

    solver = sssp.Solver(graph)             # CUDA unless device="cpu"
    res = solver.solve(0)                   # one source
    batch = solver.solve_batch([0, 7, 42])  # many sources, one run
    batch[1].path_to(99)                    # lazy parents/paths

Backends (``backend=``): "segment" (scatter-min over the dst-sorted edge
list), "ell"/"pallas" (dense in-neighbour layout through the fused ELL
relax and masked-min kernels), "frontier" (compacted sparse-frontier
rounds through the scatter-min kernel; "auto" picks it for
thin-wavefront graphs).  The dynamic, landmark, bidirectional, fleet and
distributed subsystems of ``repro.sssp`` are queued in ROADMAP.md.
"""
from repro_torch.core.graph import (  # noqa: F401
    CsrGraph, EllGraph, Graph, HostGraph, build_csr, build_ell, build_graph)
from repro_torch.core.sssp.backends import Primitives  # noqa: F401
from repro_torch.core.sssp.engine import (  # noqa: F401
    SP1_RULES, SP2_RULES, SP3_CONFIG, SP3_RULES, SP4_CONFIG, SSSPConfig,
    SSSPResult)
from repro_torch.core.sssp.parents import (  # noqa: F401
    extract_path, parent_pointers)
from repro_torch.core.sssp.reference import (  # noqa: F401
    dijkstra, sp1, sp2, sp3)
from repro_torch.core.sssp.solver import (  # noqa: F401
    BACKENDS, Solver, SSSPBatchResult)
