"""Build and load the hand-written CUDA kernels (``pfd_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/pfd_tpu_torch/lib<name>-<hash>.so``
under the repository root, and loaded with ``ctypes``. The hash covers the
source, the shared header and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built at import: the first launch
(or ``build()``) builds, and ``build()`` starts one ``nvcc`` per source, all
together. Each call of ``build()`` that compiled anything is logged in
:data:`BUILDS`, so that a reader of set-up times can take the compiler's
seconds out.

The kernels are forward-only: a wrapper writes into a fresh tensor through
raw pointers, so its output has no ``grad_fn``. Every launch wrapper calls
``forward_only`` first, and raises where autograd would record the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pfd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

# C entry point of each source and its ctypes argument types
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention": ("pfd_flash_attention_bf16",
                        (_VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP)),
    "cross_attention": ("pfd_cross_attention_bf16",
                        (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _VP)),
    "flash_attention_int8": ("pfd_flash_attention_int8",
                             (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP)),
    "flash_attention_pv8": ("pfd_flash_attention_pv8",
                            (_VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP)),
    "conv_int8": ("pfd_conv_int8",
                  (_VP, _VP, _VP) + (_I,) * 13 + (_VP,)),
    "flash_attention_pipe": ("pfd_flash_attention_pipe_bf16",
                             (_VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP)),
    "conv3x3_bf16": ("pfd_conv3x3_bf16", (_VP,) * 8 + (_I,) * 6 + (_VP,)),
    "matmul_int8": ("pfd_matmul_int8", (_VP, _VP, _VP, _I, _I, _I, _VP)),
    "span_mark": ("pfd_span_mark", (_I, _I, _VP)),
}

_loaded: dict = {}  # name -> (CDLL, entry point); the CDLL stays referenced
# {"t": wall-clock end, "seconds", "names"} of each build() that compiled
BUILDS: list = []


def _flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``: :data:`NVCC_FLAGS`, and for the
    span markers the table of their names (``profiling.DEVICE_SPANS``)."""
    if name != "span_mark":
        return NVCC_FLAGS
    from pfd_tpu_torch.utils import profiling

    return NVCC_FLAGS + ("-DPFD_DEVICE_SPANS=" + "".join(f"X({n})" for n in
                                                        profiling.DEVICE_SPANS),)


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Returns
    {name: {"seconds", "ptxas" (compiler report), "path"}}; a library that
    was already built reports 0 seconds. Raises with the compiler's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log, procs, t0 = {}, {}, time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log[name] = {"seconds": 0.0, "ptxas": "", "path": str(out)}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        text, _ = proc.communicate()
        log[name] = {"seconds": time.perf_counter() - t0, "ptxas": text,
                     "path": str(out)}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if procs:
        BUILDS.append({"t": time.time(), "seconds": time.perf_counter() - t0,
                       "names": sorted(procs)})
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return log


def entry(name: str):
    """The C entry point of ``csrc/<name>.cu`` with its ctypes signature,
    building the library first if needed."""
    if name not in _loaded:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        fn_name, argtypes = SIGNATURES[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = (lib, fn)
    return _loaded[name][1]


def records_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None allowed): grad
    enabled and one of them requiring grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def forward_only(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` where autograd records the call
    (``records_grad``): a kernel's output would be detached from its inputs
    and the gradient silently wrong. The dispatchers route such calls to
    plain attention instead (``flash_attention.kernel_takes``)."""
    if records_grad(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernels are forward-only, and an input "
                           "requires grad while grad is enabled; run it under "
                           "torch.no_grad() or through plain attention")
