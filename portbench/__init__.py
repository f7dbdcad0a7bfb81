"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One run drives one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload kron.batch8 --seed 7 --seconds 30 --trace 0

Everything a cell needs is found by name, each piece in a file of its own:

  * ``BENCHMARK.json``: the cells (``workloads``), their configurations
    and metrics;
  * ``configs/<name>.json``: a deployment (graph family, scale, weights,
    root rule), the file a configuration's ``file`` names;
  * ``graphs/<generator>.py``: the generator a configuration names, which
    makes its graph on the device from the seed;
  * ``traffic/<name>.json``: a traffic mix (which call, sources a
    request), read by ``traffic.py``;
  * ``metrics/<name>.py``: one reader a metric (the part of its name
    before the first dot), which takes its number from the run's record
    or trace and returns ``None`` where there is nothing to read.

``reference.py`` is the plain shortest-path reference that decides
``correct``; ``trace.py`` reduces a ``torch.profiler`` trace to busy and
idle time.  Nothing here imports ``jax`` or the JAX package ``repro``.
"""
