"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).  The libraries go
into ``kzg_rust_tpu_torch/build/`` (gitignored), named by a hash of the
sources, the generated headers and the flags, at the first launch in a
process; all sources build in parallel.  ``KZG_TORCH_BUILD_DIR`` overrides
the directory.  The generated headers (:func:`generated`: the device
pairing's program tables, from :mod:`.pairing_programs`) are written into
the build directory before the compile and found on its include path.

:func:`launch` is the one place a kernel is launched: it checks the
return code of the C entry point (``cudaGetLastError()`` after the launch)
and adds one to :data:`LAUNCHES` for that entry point.  Under CUDA-graph
capture (inside :func:`capturing`) nothing launches, so it adds to
:data:`CAPTURED` instead; a :class:`Graph` knows from that what one replay
runs, and each replay adds one to ``LAUNCHES`` under the graph's name.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_BINARY = [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P]
_CMP = [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _P]

# entry point -> (source file, argtypes)
ENTRY_POINTS = {
    "kzg_fp_mont_mul": ("field_kernels.cu", _BINARY),
    "kzg_fr_mont_mul": ("field_kernels.cu", _BINARY),
    "kzg_fp_add": ("field_kernels.cu", _BINARY),
    "kzg_fp_sub": ("field_kernels.cu", _BINARY),
    "kzg_fr_add": ("field_kernels.cu", _BINARY),
    "kzg_fr_sub": ("field_kernels.cu", [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P]),
    "kzg_fp_cmp": ("field_kernels.cu", _CMP),
    "kzg_fr_cmp": ("field_kernels.cu", _CMP),
    "kzg_fr_ingest": ("field_kernels.cu", [_P, _P, _P, _I64, _I64, _P]),
    "kzg_fr_sum_rows": ("field_kernels.cu", [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P]),
    "kzg_fp_pow_const": ("field_kernels.cu", [_P, _P, _I64, _P, _I64, _P]),
    "kzg_fr_pow_const": ("field_kernels.cu", [_P, _P, _I64, _P, _I64, _P]),
    "kzg_proj_add": ("curve_kernels.cu", [_P, _P, _P, _I64, _P]),
    "kzg_proj_double": ("curve_kernels.cu", [_P, _P, _I64, _P]),
    "kzg_proj_double_chain": ("curve_kernels.cu", [_P, _P, _I64, _I64, _P]),
    "kzg_glv_digits": ("msm_kernels.cu", [_P, _P, _I64, _I64, _P]),
    "kzg_msm_glv": ("msm_kernels.cu", [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P]),
    "kzg_proj_add_mixed": ("msm_kernels.cu", [_P, _P, _P, _I64, _P]),
    "kzg_g1_decompress": ("stage1_kernels.cu", [_P, _P, _P, _P, _I64, _I64, _P, _I64, _P]),
    "kzg_g1_subgroup_check": ("stage1_kernels.cu", [_P, _P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _P]),
    "kzg_fp12_op": ("pairing_kernels.cu", [_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]),
    "kzg_miller_loop": ("pairing_kernels.cu", [_P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, _P]),
    "kzg_final_exp": ("pairing_kernels.cu", [_P, _P, _I64, _P, _I64, ctypes.c_int, ctypes.c_int, _P]),
}

# Launches per entry point since the last reset_launches(): plain ints,
# incremented only in launch(); and per Graph name, its replays (one each).
LAUNCHES: dict[str, int] = {name: 0 for name in ENTRY_POINTS}
# Per entry point, the launches recorded into CUDA graphs (never reset).
CAPTURED: dict[str, int] = {name: 0 for name in ENTRY_POINTS}

# Per source: seconds its nvcc took and what ptxas reported (registers,
# spills), filled by build().
BUILD_INFO: dict[str, dict] = {}

_LOCK = threading.Lock()
_FUNCS: dict[str, ctypes._CFuncPtr] = {}
_CAPTURE = threading.local()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> str:
    return os.environ.get("KZG_TORCH_BUILD_DIR") or os.path.join(_PKG, "build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def generated() -> dict[str, str]:
    """The headers that the sources include and Python writes at build
    time, by file name: ``pairing_programs.cuh``, the device pairing's
    programs (:func:`.pairing_programs.header_text`)."""
    from . import pairing_programs

    return {"pairing_programs.cuh": pairing_programs.header_text()}


def _digest(headers: dict[str, str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as fh:
                h.update(name.encode() + fh.read())
    for name, text in sorted(headers.items()):
        h.update(name.encode() + text.encode())
    return h.hexdigest()[:12]


def _write(path: str, text: str) -> None:
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)


def build() -> dict[str, str]:
    """Compile every source that has no library yet, all in parallel,
    the generated headers written first into ``include-<hash>/`` of the
    build directory.  Returns source -> library path; raises with nvcc's
    output on failure."""
    headers = generated()
    digest = _digest(headers)
    sources = sorted({src for src, _ in ENTRY_POINTS.values()})
    paths = {src: os.path.join(build_dir(), f"lib{os.path.splitext(src)[0]}-{digest}.so") for src in sources}
    todo = [src for src in sources if not os.path.exists(paths[src])]
    if not todo:
        return paths
    include = os.path.join(build_dir(), f"include-{digest}")
    os.makedirs(include, exist_ok=True)
    for name, text in headers.items():
        _write(os.path.join(include, name), text)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        tmp = f"{paths[src]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", include, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        )
    errors = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_INFO[src] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[src])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _func(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        with _LOCK:
            if not _FUNCS:
                paths = build()
                libs = {src: ctypes.CDLL(path) for src, path in paths.items()}
                for entry, (src, argtypes) in ENTRY_POINTS.items():
                    f = getattr(libs[src], entry)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _FUNCS[entry] = f
            fn = _FUNCS[name]
    return fn


def launch(name: str, device, *args) -> None:
    """Launch entry point ``name`` on ``device``'s current stream: ``args``
    are tensors (passed as device pointers), ints, ``bytes`` (passed as
    host pointers) and None (a null pointer)."""
    import torch

    if device.type != "cuda":
        raise RuntimeError(f"{name}: kernels launch only on CUDA tensors, got {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(f"{name}: tensors on {device}, current device is another")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = _func(name)(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    (CAPTURED if getattr(_CAPTURE, "on", False) else LAUNCHES)[name] += 1


def on_device(device):
    """``torch.cuda.device(device)`` for a CUDA device, so that launches on
    its tensors find it current (:func:`launch` checks); nothing for the
    CPU."""
    import torch

    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@contextlib.contextmanager
def capturing():
    """Mark this thread's launches as recorded into a CUDA graph (counted in
    CAPTURED, not LAUNCHES) for the block: wrap every capture in it."""
    _CAPTURE.on = True
    try:
        yield
    finally:
        _CAPTURE.on = False


class Graph:
    """A launch sequence captured once as a CUDA graph, then replayed.

    ``fn()`` runs once on a side stream first, so that the libraries are
    loaded and the cached constants it uploads exist before the capture
    (a capture may not copy from pageable memory); then ``torch.cuda.graph``
    captures it.  ``outputs`` is what the capture returned: tensors in the
    graph's private memory pool that every replay rewrites, alive as long
    as this object.  ``kernels`` is what one replay launches, by entry
    point.  Each :meth:`replay` adds one to ``LAUNCHES[name]``.  A capture
    that fails raises."""

    def __init__(self, name: str, fn, device):
        import torch

        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()
            cur.wait_stream(side)
            before = dict(CAPTURED)
            self.graph = torch.cuda.CUDAGraph()
            with capturing(), torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = fn()
        self.name = name
        self.kernels = {e: c - before[e] for e, c in CAPTURED.items() if c != before[e]}
        LAUNCHES.setdefault(name, 0)

    def replay(self) -> None:
        self.graph.replay()
        LAUNCHES[self.name] += 1
