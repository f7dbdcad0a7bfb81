"""Build, load and count the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all of
them started together) for ``sm_90a`` into a shared library with a plain
C interface, ``build/repro_torch/lib<name>-<hash>.so`` under the checkout
(the hash is of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source rebuilds), and
loaded with ``ctypes``.  Nothing is compiled at import: the first wrapper
call on a CUDA tensor builds everything, or ``build_all()`` does it up
front.

Every wrapper adds one to ``LAUNCHES[<wrapper>]`` after it launched its
kernel, and nowhere else, so a run can show which kernels it went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every exported function: (source, argtypes); each
# returns the cudaError_t of its launches as an int.
SIGNATURES = {
    "frontier_scatter_min_batch": ("frontier_relax",
                                   (_P, _P, _P, _I, _L, _I, _I, _P)),
    "frontier_relax_csr": ("frontier_relax",
                           (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P)),
    "relax_ell": ("relax", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P)),
    "masked_min": ("segment_min", (_P, _P, _P, _P, _P, _I, _L, _I, _I, _P)),
    "masked_min_pair": ("segment_min",
                        (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P)),
    "cin_layer": ("cin", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P)),
    "cin_weight_grad": ("cin", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P)),
    "flash_attention": ("flash_attn",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "flash_attention_lse": ("flash_attn",
                            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P)),
    "flash_attention_bwd": ("flash_attn_bwd",
                            (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _P)),
}
SOURCES = tuple(sorted({src for src, _ in SIGNATURES.values()}))

LAUNCHES: dict[str, int] = {
    "frontier_relax": 0,
    "frontier_scatter_min": 0,
    "frontier_scatter_min_batch": 0,
    "frontier_relax_csr": 0,
    "relax_ell": 0,
    "masked_min": 0,
    "masked_min_pair": 0,
    "cin_layer": 0,
    "cin_weight_grad": 0,
    "flash_attention": 0,
    "flash_attention_lse": 0,
    "flash_attention_bwd": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared helpers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every missing library in parallel; returns the seconds spent.

    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler says
    (registers, shared memory and spills of each kernel).
    """
    t0 = time.perf_counter()
    todo = [name for name in SOURCES if not _lib_path(name).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        cmd = [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(out) + ".tmp", str(CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {name}.cu]\n{log.strip()}")
        os.replace(str(_lib_path(name)) + ".tmp", _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _typed(lib: ctypes.CDLL, fn: str):
    f = getattr(lib, fn)
    f.argtypes = SIGNATURES[fn][1]
    f.restype = ctypes.c_int
    return f


def function(fn: str):
    """The ctypes function ``fn`` of its library, building on first use
    (bound once, so a wrapper's call costs one dict lookup here)."""
    f = _fns.get(fn)
    if f is not None:
        return f
    src = SIGNATURES[fn][0]
    if src not in _libs:
        build_all()
        _libs[src] = ctypes.CDLL(str(_lib_path(src)))
    f = _fns[fn] = _typed(_libs[src], fn)
    return f


def edit_source(fn: str, edits) -> str:
    """The text of ``fn``'s source with ``edits`` applied: each ``(old,
    new)`` pair replaces a string that must occur exactly once."""
    src = SIGNATURES[fn][0]
    text = (CSRC / f"{src}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{src}.cu: an edit's anchor occurs "
                             f"{text.count(old)} times, not once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variant(fn: str, edits, out_dir) -> ctypes._CFuncPtr:
    """The ctypes function ``fn`` of a copy of ``csrc/`` in ``out_dir``
    with ``edits`` applied (``edit_source``), built with ``NVCC_FLAGS``:
    a mutant or an ablation, never cached.  The wrappers go on launching
    the built library unless ``use`` is given the result."""
    out = Path(out_dir)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    src = SIGNATURES[fn][0]
    path = out / f"{src}.cu"
    path.write_text(edit_source(fn, edits))
    lib = out / f"lib{src}.so"
    run = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(lib), str(path)],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{run.stdout}"
                           f"{run.stderr}")
    return _typed(ctypes.CDLL(str(lib)), fn)


def use(fn: str, f=None) -> None:
    """Make the wrappers launch ``f`` (from ``build_variant``) for ``fn``;
    ``None`` goes back to the built library."""
    if f is None:
        _fns.pop(fn, None)
    else:
        _fns[fn] = f


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, for a C launch.

    ``torch.cuda.current_stream(device).cuda_stream`` gives the same
    handle but builds a Stream object on every call, host time that a
    wrapper pays on every launch (chip_smoke.py prints the fused frontier
    wrapper's host cost)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
