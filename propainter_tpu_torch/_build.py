"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use by its own `nvcc` process into `build/kernels/<name>-<digest>.so` at the
root of the checkout (the digest covers the source, every `csrc/*.cuh`
header and the flags, so an edited kernel or header is rebuilt), then
loaded with `ctypes`. The compiler's output (`-Xptxas -v`: each kernel's
registers, spills and shared memory) is kept beside the library as
`<name>-<digest>.log`. Every pointer and the CUDA stream cross the boundary
as `ctypes.c_void_p`; every C entry returns `cudaGetLastError()` and
`check` raises when it is not 0.

Nothing here runs at import: the CPU tests import every module, and a CPU
host has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("corr_lookup", "corr_lookup_moenc", "corr_pyramid_build",
                  "deform_conv", "sparse_window_attention", "window_attention")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found: the CUDA kernels are built on a machine "
            f"with the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named source that is not built yet, one `nvcc` each,
    all started together. Returns {name: seconds} for the ones compiled;
    raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    times, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[name] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
            continue
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_log(name: str) -> str:
    """The compiler's output for the built `name` (build it first)."""
    return _target(name).with_suffix(".log").read_text()


def sass(name: str) -> str:
    """The SASS of the built `name` (`cuobjdump -sass`; build it first)."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def function(lib_name: str, symbol: str, n_ptrs: int, n_ints: int,
             n_floats: int = 0):
    """The C entry `symbol` of `lib_name`, declared as `n_ptrs` pointers,
    `n_ints` ints, `n_floats` floats, then the stream; returns int (a
    cudaError_t)."""
    key = (lib_name, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            path = _target(lib_name)
            if not path.exists():
                build((lib_name,))
            lib = _libs[lib_name] = ctypes.CDLL(str(path))
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch(fn, what: str, like, *args) -> None:
    """Call the C entry `fn(*args, stream)` with the device of the tensor
    `like` current and that device's current PyTorch stream, and raise if
    it reports a CUDA error. Each C entry configures and launches its
    kernel on the runtime's current device, so on a host with several GPUs
    a tensor on the second one must not be launched on the first."""
    import torch

    with torch.cuda.device(like.device):
        check(fn(*args, torch.cuda.current_stream(like.device).cuda_stream),
              what)


def require_cuda(*tensors) -> None:
    """Kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (the kernel); anything else is refused rather than silently moved."""
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(
                f"expected a CUDA tensor, got one on {t.device}")
