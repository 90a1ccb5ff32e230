"""Build and load the port's native code.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use
with nvcc into a shared library under `muzero_general_tpu_torch/_build/`
(listed in .gitignore), then loaded with ctypes. The replay buffer's batch
assembler (`native/replay_sampler.cpp`, a CPython/numpy extension) is
compiled at first use with the host's g++ into the same directory and
imported. Each built file's name carries a hash of its source and flags, so
an edited source is rebuilt. Nothing is compiled when a module is imported,
and a build that fails raises.
"""

import concurrent.futures
import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
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
    "mcts_kernels": {
        # The staged search's descent and backprop: no FMA contraction, so
        # they match their plain versions (ops/mcts_kernels.py) bit for bit.
        "flags": ["--fmad=false"],
        "api": {
            "mcts_descend_planar": (
                ctypes.c_int,
                [ctypes.c_void_p] * 14
                + [ctypes.c_int] * 6
                + [ctypes.c_float] * 4
                + [ctypes.c_ulonglong, ctypes.c_void_p],
            ),
            "mcts_descend": (
                ctypes.c_int,
                [ctypes.c_void_p] * 14
                + [ctypes.c_int] * 5
                + [ctypes.c_float] * 4
                + [ctypes.c_ulonglong, ctypes.c_void_p],
            ),
            "mcts_backprop": (
                ctypes.c_int,
                [ctypes.c_void_p] * 12
                + [ctypes.c_int] * 7
                + [ctypes.c_float] * 2
                + [ctypes.c_void_p],
            ),
            "mcts_kernels_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        },
    },
    "mcts_stream": {
        # The streaming search's descent and edge updates: no FMA
        # contraction, so they match their plain versions
        # (ops/mcts_stream.py) bit for bit.
        "flags": ["--fmad=false"],
        "api": {
            "mcts_stream_descend": (
                ctypes.c_int,
                [ctypes.c_void_p] * 13
                + [ctypes.c_int] * 6
                + [ctypes.c_float] * 4
                + [ctypes.c_ulonglong, ctypes.c_void_p],
            ),
            "mcts_stream_update": (
                ctypes.c_int,
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            ),
            "mcts_stream_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        },
    },
    "hidden_store": {
        # A pure copy, built with the package's common flags.
        "flags": ["--fmad=false"],
        "api": {
            "mcts_write_node_hidden": (
                ctypes.c_int,
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p],
            ),
            "hidden_store_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        },
    },
    "conv_probe": {
        # The conv probe's two kernels: held to a tolerance (tensor-core sums
        # in another order than a PyTorch matmul's), so FMA contraction
        # stays on.
        "flags": [],
        "api": {
            "conv_probe_9dot": (
                ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            ),
            "conv_probe_im2col": (
                ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            ),
            "conv_probe_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        },
    },
    "stream_probe": {
        # The stream probe's pointer chase (sums only, held to a tolerance)
        # and its latency floor (row indices, exact; launched only by
        # tools/stream_probe_cost.py).
        "flags": [],
        "api": {
            "stream_probe_chase": (
                ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            ),
            "stream_probe_floor": (
                ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            ),
            "stream_probe_error_string": (ctypes.c_char_p, [ctypes.c_int]),
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


def build_all(names=None) -> dict:
    """Build several kernels at once, one nvcc process each, all started
    together. Returns {name: build(name)'s result}; raises if any fails."""
    names = list(_KERNELS) if names is None else list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: future.result() for name, future in futures.items()}


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



# ---- the replay buffer's batch assembler (g++, a CPython extension) ------

REPLAY_SRC = PACKAGE_DIR / "native" / "replay_sampler.cpp"
# No FMA contraction: every product is rounded where numpy rounds it, so
# the assembler's targets equal the numpy path's bit for bit.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]


def _gxx_command(out):
    import numpy as np

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the replay batch assembler needs a host C++ compiler")
    return [gxx, *GXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
            str(REPLAY_SRC), "-o", str(out)]


def replay_native_path() -> pathlib.Path:
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    key = REPLAY_SRC.read_bytes() + " ".join(_gxx_command("")).encode()
    return BUILD_DIR / f"_replay_native-{hashlib.sha256(key).hexdigest()[:16]}{suffix}"


def build_replay_native() -> dict:
    """Compile the batch assembler unless it is already built. Returns
    {"path", "seconds" (0 when cached), "log"}; raises if g++ fails."""
    out = replay_native_path()
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(_gxx_command(tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {REPLAY_SRC.name}:\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load_replay_native():
    """Build if needed and import the batch assembler's module (once a
    process for each source file)."""
    module = _loaded.get(REPLAY_SRC)
    if module is None:
        path = build_replay_native()["path"]
        spec = importlib.util.spec_from_file_location("_replay_native", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[REPLAY_SRC] = module
    return module
