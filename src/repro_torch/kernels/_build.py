"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an object with
a plain C interface, all sources at once in parallel, and the objects are
linked into one shared library loaded with ``ctypes``. The build runs on
first use into ``kernels/_build/<hash of the sources and flags>/`` (listed
in ``.gitignore``), so a fresh checkout builds everything it runs from the
sources in the repository and a stale library is never reused. Nothing is
built when this module is imported: CPU hosts, which have no ``nvcc``,
import every module of the package. Processes that build at once (ranks
or spawned workers sharing a checkout) take turns on a file lock in the
build directory, so one compiles and the others load what it built;
``BUILT`` lists the builds this process compiled itself.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. ``LAUNCHES`` counts
kernel launches per wrapper: each wrapper adds one where it launches its
kernel on the card, and nowhere else. A wrapper called while a CUDA graph
is captured counts too, though nothing runs then: ``captured_launches``
takes those counts back out and keeps them as the graph's launches, and
``add_replay`` adds them again for every replay, so the counts are the
same whether an encode ran eagerly or as a graph.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "BUILT", "NVCC_FLAGS", "build", "library", "check",
           "captured_launches", "add_replay",
           "ptxas_report", "aligned16", "stream_ptr", "strides_arg",
           "words_arg", "DTYPE_SUFFIX"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# kernel name -> launches on the card since the last reset (clear() resets);
# a kernel with several entries also counts each under "<kernel>.<entry>"
LAUNCHES: collections.Counter = collections.Counter()

# build directories this process compiled (empty where it loaded a library
# another process built)
BUILT: list[Path] = []


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a Counter that holds, once the
    block ends, the launches the wrappers counted inside it, and leaves
    ``LAUNCHES`` as it was before the block (a capture launches nothing).
    Pass the Counter to ``add_replay`` at every replay of the graph."""
    before = LAUNCHES.copy()
    graph: collections.Counter = collections.Counter()
    try:
        yield graph
    finally:
        graph.update(LAUNCHES - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)


def add_replay(graph: collections.Counter) -> None:
    """Count one replay of a graph whose launches ``captured_launches``
    recorded: each kernel in it launches once more."""
    LAUNCHES.update(graph)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint
_I64 = ctypes.c_longlong
_FLOAT = ctypes.c_float
_UINT_PTR = ctypes.POINTER(ctypes.c_uint)     # a host array of 32-bit words
_I64_PTR = ctypes.POINTER(ctypes.c_longlong)   # a host array of strides
# C entry point -> argtypes. Pointers and the stream are c_void_p: ctypes
# would otherwise pass a Python int as a 32-bit int and cut the pointer.
_SIGNATURES = {
    "photonic_matmul_s8": (_VOID,) * 5 + (_INT,) * 3 + (_VOID,),
    "photonic_matmul_s8_kmajor": (_VOID,) * 5 + (_INT,) * 3 + (_VOID,),
    "flash_attention_masked_f32": (_VOID,) * 6 + (_INT,) * 9 + (_FLOAT,
                                                                _VOID),
    "flash_attention_masked_tc_f32": (_VOID,) * 6 + (_I64_PTR,) + (_INT,) * 7
    + (_FLOAT, _VOID),
    "flash_attention_masked_wide_f32": (_VOID,) * 6 + (_I64_PTR, _VOID)
    + (_INT,) * 8 + (_FLOAT, _VOID),
    "fused_ffn_phase0": (_VOID,) * 7 + (_INT,) * 3 + (_VOID,),
    "fused_ffn_phase1": (_VOID,) * 5 + (_INT,) * 4 + (_FLOAT, _VOID),
    "fused_ffn_kmajor": (_VOID,) * 11 + (_INT,) * 5 + (_FLOAT, _VOID),
    "fused_ffn_kmajor_hidden": (_VOID,) * 7 + (_INT,) * 3 + (_VOID,),
    "fused_ffn_kmajor_out": (_VOID,) * 6 + (_INT,) * 4 + (_FLOAT, _VOID),
    "flash_attention_causal_f32": (_VOID,) * 4 + (_I64_PTR,) + (_INT,) * 8
    + (_FLOAT, _VOID),
    "flash_attention_causal_bf16": (_VOID,) * 4 + (_I64_PTR,) + (_INT,) * 8
    + (_FLOAT, _VOID),
    "flash_decode_f32": (_VOID,) * 4 + (_I64_PTR,) + (_INT,) * 5
    + (_FLOAT, _VOID),
    "flash_decode_bf16": (_VOID,) * 4 + (_I64_PTR,) + (_INT,) * 5
    + (_FLOAT, _VOID),
    "dequant_epilogue_s32": (_VOID,) * 4 + (_INT,) * 2 + (_VOID,),
    "noise_transmission_s8": (_VOID, _VOID, _I64, _VOID, _UINT_PTR, _INT)
    + (_UINT,) * 3 + (_FLOAT,) * 6 + (_INT, _VOID),
    "noise_transmission_f32": (_VOID, _VOID, _I64, _VOID, _UINT_PTR, _INT)
    + (_UINT,) * 3 + (_FLOAT,) * 6 + (_INT, _VOID),
    "noise_readout_shot": (_VOID, _I64, _VOID, _UINT_PTR, _INT, _UINT,
                           _FLOAT, _VOID),
    "noise_draw_bits": (_VOID, _I64, _VOID, _UINT_PTR, _INT, _UINT, _UINT,
                        _VOID),
    "flash_attention_masked_smem": (_INT, _INT),
    "max_dynamic_smem": (_INT,),
}

_lib: ctypes.CDLL | None = None
_ptxas: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of repro_torch are built on first use on a machine with "
            "the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every kernel source (in parallel) and link the library;
    returns its path. A library already built from identical sources and
    flags is reused. ``-Xptxas -v`` output (registers, shared memory,
    spills) is kept per source in ``ptxas_report()``."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libreprokernels.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        # one process compiles at a time; a waiter finds the library built
        with open(out_dir / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.is_file():
                _compile(out_dir, lib_path, verbose)
                BUILT.append(out_dir)
                return lib_path
    for p in _sources():
        log = out_dir / (p.stem + ".ptxas.txt")
        if log.is_file():
            _ptxas[p.name] = log.read_text()
    return lib_path


def _compile(out_dir: Path, lib_path: Path, verbose: bool) -> None:
    nvcc = _nvcc()
    tag = str(os.getpid())
    procs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    objs = []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        _ptxas[src.name] = log
        (out_dir / (src.stem + ".ptxas.txt")).write_text(log)
        if verbose:
            print(f"[build] {src.name}:\n{log}", flush=True)
        if proc.returncode != 0:
            failures.append(f"{src.name} (rc {proc.returncode}):\n{log}")
        objs.append(str(obj))
    if failures:
        raise RuntimeError("nvcc failed to compile:\n" + "\n".join(failures))
    tmp = out_dir / f"libreprokernels.{tag}.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                           str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link:\n{link.stdout}")
    os.replace(tmp, lib_path)          # atomic: a reader sees it whole
    for o in objs:
        Path(o).unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ptxas_report() -> dict[str, str]:
    """Source file -> ``-Xptxas -v`` output of the build in use."""
    return dict(_ptxas)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


# tensor dtype -> suffix of the C entry point instantiated for it
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def strides_arg(*strides: int):
    """A host array of element strides for an ``_I64_PTR`` argument (the
    C entry point reads it before it returns)."""
    return (ctypes.c_longlong * len(strides))(*strides)


def words_arg(*words: int):
    """A host array of 32-bit words for a ``_UINT_PTR`` argument (the C
    entry point copies it into the launch's arguments)."""
    return (ctypes.c_uint * max(1, len(words)))(*words)


def aligned16(t: torch.Tensor, dims: int) -> bool:
    """Whether ``t``'s data pointer and its first ``dims`` strides fall on
    16-byte boundaries (what a kernel's 16-byte loads need)."""
    return t.data_ptr() % 16 == 0 and all(
        s_ * t.element_size() % 16 == 0 for s_ in t.stride()[:dims])


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
