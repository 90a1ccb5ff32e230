"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use
with nvcc into a shared library under `muzero_general_tpu_torch/_build/`
(listed in .gitignore), then loaded with ctypes. The library's file name
carries a hash of its source and flags, so an edited source is rebuilt.
Nothing is compiled when a module is imported.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register, shared-memory and spill report per kernel
]

# Per kernel: its own nvcc flags, and the C interface ctypes declares.
_KERNELS = {
    "mcts_fused": {
        # No FMA contraction: every product is rounded before it is added,
        # as by the plain version's separate PyTorch ops, so pUCT argmaxes
        # match it bit for bit.
        "flags": ["--fmad=false"],
        "api": {
            "mcts_fused_search": (
                ctypes.c_int,
                [ctypes.c_void_p] * 9
                + [ctypes.c_int] * 6
                + [ctypes.c_float] * 4
                + [ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p],
            ),
            "mcts_fused_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        },
    },
}

_loaded = {}


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def nvcc_flags(name: str) -> list:
    return NVCC_FLAGS + _KERNELS[name]["flags"]


def library_path(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless its library is already built.

    Returns {"path", "seconds" (0 when cached), "log"} where log is the
    compiler's output, with ptxas' resource report.
    """
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": out, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface of one kernel."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)["path"]))
        for fn_name, (restype, argtypes) in _KERNELS[name]["api"].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _loaded[name] = lib
    return lib

