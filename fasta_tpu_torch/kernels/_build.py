"""Build and load the port's CUDA kernels.

The sources under ``fasta_tpu_torch/csrc/`` expose a plain C interface;
they are compiled at first use, one ``nvcc`` per source, all started
together, then linked into one shared library and loaded with
``ctypes``.  The library goes to ``build/fasta_tpu_torch/``
beside the package, named by a hash of the sources and flags, so a stale
library is never loaded.  Nothing is built when a module is imported:
only a call on a CUDA tensor reaches :func:`library`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "library_path", "on_device", "check", "ints",
           "sm_count", "stream_scratch", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fasta_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)

# C entry points: name -> argtypes (every one returns a cudaError_t)
_SIGNATURES = {
    "fasta_gradmap_plan": [_I, _I, _I, _P, _P, _P, _P],
    "fasta_gradmap": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P],
    "fasta_microsolve_grid": [_I, _P, _P, _P, _P],
    "fasta_microsolve_work": [_I, _I, _I, _I, _P],
    "fasta_microsolve": [_P, _P, _I, _P, _I, _P, _F, _P, _I, _F,
                         _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _P, _P, _P, _I, _P],
    "fasta_fbs_work_doubles": [_I, _P],
    "fasta_shrink_step": [_P, _P, _P, _F, _P, _F, _I, _I, _I, _I, _P, _P,
                          _P, _P],
    "fasta_tv_gradmap": [_P, _P, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P],
    "fasta_microsolve_tv_grid": [_P, _P],
    "fasta_planar_gradmap_plan": [_I, _I, _I, _P, _P, _P, _P, _P, _P],
    "fasta_planar_gradmap": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P, _P, _P, _P, _P],
    "fasta_planar_probe_grid": [_I, _I, _P],
    "fasta_bf16_probe_grid": [_I, _I, _P, _P, _P, _P],
    "fasta_bf16_probe_work": [_I, _I, _I, _P],
    "fasta_bf16_probe": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I,
                         _P],
    "fasta_gradmap_probe_grid": [_I, _P, _P, _P, _P],
    "fasta_gradmap_probe_work": [_I, _I, _P],
    "fasta_gradmap_probe": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                            _I, _P],
    "fasta_matvec_probe_grid": [_I, _I, _P],
    "fasta_matvec_probe": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P, _P, _P, _I, _P],
    "fasta_tail_probe_grid": [_I, _P, _P, _P, _P],
    "fasta_tail_probe_work": [_I, _I, _I, _P],
    "fasta_tail_probe": [_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _I, _P, _I, _P],
    "fasta_microsolve_planar_grid": [_I, _P, _P, _P, _P],
    "fasta_microsolve_planar_work": [_I, _I, _I, _I, _P],
    "fasta_microsolve_planar": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _F,
                                _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _P, _P, _P, _I, _P],
    "fasta_planar_probe": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                           _P],
    "fasta_microsolve_tv": [_P, _I, _P, _I, _P, _I, _P, _I, _F, _I, _I, _I,
                            _I, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                            _P],
}


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sum(_sources(), []):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libfasta_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build the kernels")
    return str(path)


def _compile(out: Path) -> None:
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = out.with_suffix(f".{pid}.tmp")
    objs = [out.with_name(f"{out.stem}.{src.stem}.{pid}.o") for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        steps.append((link, proc.stdout, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    # -Xptxas -v reports registers, shared memory and spills per kernel
    out.with_suffix(".log").write_text("".join(
        f"$ {' '.join(cmd)}\n{text}" for cmd, text, _ in steps))
    for cmd, text, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{text}")
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if missing."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fasta_error_string.argtypes = [_I]
    lib.fasta_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        name = library().fasta_error_string(err).decode()
        raise RuntimeError(f"{what} failed with cudaError_t {err} ({name})")


def ints(what: str, *args, count: int = 1) -> list:
    """The ``count`` ints that the C entry point ``what``, called with
    ``args``, writes through its last ``count`` pointers; raises as
    ``check``."""
    out = [ctypes.c_int() for _ in range(count)]
    check(getattr(library(), what)(*args, *map(ctypes.byref, out)), what)
    return [v.value for v in out]


@contextlib.contextmanager
def on_device(device):
    """Make ``device`` current for a C call (only when it is not already)
    and yield the raw handle of its current stream, on which the kernels
    launch (the handle PyTorch's own launches use, without building a
    ``torch.cuda.Stream``)."""
    import torch
    guard = (contextlib.nullcontext() if torch.cuda.current_device() ==
             device.index else torch.cuda.device(device))
    with guard:
        yield torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of a CUDA device."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream handle) -> [float64 buffer, whether its ticket is
# known to be zero outside any CUDA graph]
_SCRATCH = {}
# buffers replaced by a larger one, kept because a captured graph may
# still launch on them
_RETIRED = []


def stream_scratch(device, stream: int, ndoubles: int):
    """A float64 buffer of at least ``ndoubles`` on ``device`` for the
    launches on ``stream`` (a raw handle) of the kernels that finish with
    a last-block ticket (K-B4's stream route, K-B5), a last-cluster
    ticket (K-B7) or keep a grid barrier's counter and exit ticket there
    (K-B1, K-B8, K-P1, K-P2, K-P3, K-P4).  Its first double
    holds the ticket (or the two counters), which every such kernel leaves
    at zero, so the
    buffer is zeroed once and never again: launches on one stream run in
    order and share it, launches on two streams never do (C-2).  Inside a
    CUDA-graph capture the zeroing of a buffer that eager launches have not
    yet zeroed is captured too, so that every replay finds the ticket at
    zero.  Replays of graphs captured on one stream must not overlap."""
    import torch
    key = (device.index, stream)
    entry = _SCRATCH.get(key)
    capturing = torch.cuda.is_current_stream_capturing()
    if entry is None or entry[0].numel() < ndoubles:
        if entry is not None:
            _RETIRED.append(entry[0])
        entry = _SCRATCH[key] = [
            torch.zeros(max(ndoubles, 4096), dtype=torch.float64,
                        device=device), not capturing]
    elif not entry[1]:
        entry[0][:1].zero_()
        entry[1] = not capturing
    return entry[0]
