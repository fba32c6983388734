"""Build the port's CUDA sources into one shared library, at first use.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, for `sm_90a` (Hopper) with `-O3` and without fast math; the
objects are linked into one library with a plain C interface, loaded with
`ctypes`.  The library's name carries a hash of the sources, the headers
they share (`csrc/*.cuh`) and the flags, so a changed file is rebuilt and
an unchanged one is loaded as it is.  The output goes to `build/kernels/`
at the root of the checkout, or to `$REPRO_TORCH_BUILD_DIR`.  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build" / "kernels"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def compile_commands(nvcc: str, out: Path) -> tuple[list[list[str]], list[str], Path]:
    """(one compile command per source, the link command, the library path)."""
    objs = [out / (src.stem + ".o") for src in sources()]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(sources(), objs)
    ]
    lib = out / "librepro_torch_kernels.so"
    link = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(lib)]
    return compiles, link, lib


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources(), *headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def _build() -> Path:
    final = build_dir() / f"librepro_torch_kernels-{_tag()}.so"
    if final.exists():
        return final
    nvcc = find_nvcc()
    final.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=final.parent) as tmp:
        compiles, link, lib = compile_commands(nvcc, Path(tmp))
        _run(compiles)
        _run([link])
        os.replace(lib, final)
    return final


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kw_queue_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p, p, i]
    lib.kw_queue_launch.restype = i
    lib.kw_queue_tma_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, i]
    lib.kw_queue_tma_launch.restype = i
    lib.kw_queue_tma_smem_bytes.argtypes = [i, i, i, i, i]
    lib.kw_queue_tma_smem_bytes.restype = ctypes.c_longlong
    lib.residual_sample_launch.argtypes = [p, p, i, i, i, i, p, p, i, p, i]
    lib.residual_sample_launch.restype = i
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p, i]
    lib.flash_attention_launch.restype = i
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, i]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_hopper_clusters.argtypes = [i, i, i, i]
    lib.ssd_scan_hopper_clusters.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            _declare(lib)
            _lib = lib
    return _lib
