"""Build the port's CUDA kernels with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/<source>.cu`` compiles, on its own, into a shared library with
plain C entry points (no PyTorch headers, so a build takes seconds) under
``build/kernels/`` at the repository root; a source may hold several
kernels (a kernel and its packed mode or its forms, the two dtypes of K11
and of K12), each with its own entry point.  The file name carries a hash
of the source, of every header it includes from ``csrc/`` (``#include
"name"``) and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  Every entry point takes raw pointers, ints and
the CUDA stream, launches on that stream and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero return into an exception.

Nothing here runs at import time: the package imports on a machine with no
card and no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int


class Kernel(NamedTuple):
    source: str      # csrc/<source>.cu
    entry: str       # its extern "C" launch function
    argtypes: tuple


#: Each kernel's source, entry point and argument types.
KERNELS = {
    "driver_streamed": Kernel(
        "driver_streamed", "driver_streamed_launch",
        (_P,) * 11 + (_I,) * 3 + (_P,)),
    "driver_streamed_packed": Kernel(
        "driver_streamed", "driver_streamed_packed_launch",
        (_P,) * 14 + (_I,) * 4 + (_P,)),
    "topk_merge_rows": Kernel(
        "topk_merge_rows", "topk_merge_rows_launch",
        (_P, _P) + (_I,) * 4 + (_P,)),
    "delta_merge": Kernel(
        "delta_merge", "delta_merge_launch", (_P,) * 12 + (_I,) * 5 + (_P,)),
    "delta_merge_packed": Kernel(
        "delta_merge", "delta_merge_packed_launch",
        (_P,) * 18 + (_I,) * 6 + (_P,)),
    "delta_merge_packed_row": Kernel(
        "delta_merge", "delta_merge_packed_row_launch",
        (_P,) * 19 + (_I,) * 8 + (_P,)),
    "streamed_join": Kernel(
        "streamed_join", "streamed_join_launch",
        (_P,) * 15 + (_I,) * 4 + (_P,)),
    "streamed_join_packed": Kernel(
        "streamed_join", "streamed_join_packed_launch",
        (_P,) * 21 + (_I,) * 6 + (_P,)),
    "driver_compact": Kernel(
        "driver_compact", "driver_compact_launch",
        (_P,) * 10 + (_I,) * 3 + (_P,)),
    "driver_compact_packed": Kernel(
        "driver_compact", "driver_compact_packed_launch",
        (_P,) * 13 + (_I,) * 4 + (_P,)),
    "streamed_compact": Kernel(
        "streamed_compact", "streamed_compact_launch",
        (_P,) * 12 + (_I,) * 4 + (_P,)),
    "streamed_compact_packed": Kernel(
        "streamed_compact", "streamed_compact_packed_launch",
        (_P,) * 18 + (_I,) * 6 + (_P,)),
    "merge_compact": Kernel(
        "merge_compact", "merge_compact_launch",
        (_P,) * 14 + (_I,) * 5 + (_P,)),
    "merge_compact_packed": Kernel(
        "merge_compact", "merge_compact_packed_launch",
        (_P,) * 20 + (_I,) * 6 + (_P,)),
    "merge_compact_packed_row": Kernel(
        "merge_compact", "merge_compact_packed_row_launch",
        (_P,) * 21 + (_I,) * 8 + (_P,)),
    "batched_block_skip": Kernel(
        "staged_join", "batched_block_skip_launch",
        (_P,) * 9 + (_I,) * 4 + (_P,)),
    "block_skip": Kernel(
        "staged_join", "block_skip_launch", (_P,) * 7 + (_I,) * 2 + (_P,)),
    "flat_sort_i32": Kernel(
        "flat_sort", "flat_sort_i32_launch", (_P, _I, _P, _P, _I, _P)),
    "flat_sort_f32": Kernel(
        "flat_sort", "flat_sort_f32_launch", (_P, _I, _P, _P, _I, _P)),
    "flash_attention_f32": Kernel(
        "flash_attention", "flash_attention_f32_launch",
        (_P,) * 4 + (_I,) * 7 + (_P,)),
    "flash_attention_bf16": Kernel(
        "flash_attention", "flash_attention_bf16_launch",
        (_P,) * 4 + (_I,) * 7 + (_P,)),
}
#: Every kernel source.
SOURCES = tuple(dict.fromkeys(k.source for k in KERNELS.values()))
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, object] = {}
_libs: dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    path: Path
    seconds: float   # nvcc wall time; 0.0 when the library was already built
    log: str         # nvcc's output, including ptxas' registers/smem/spills


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and str(Path(home) / "bin" / "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_bytes(path: Path, seen: set[Path]) -> bytes:
    """``path``'s bytes followed by those of each header it includes from
    ``csrc/``, recursively, each file once."""
    if path in seen:
        return b""
    seen.add(path)
    text = path.read_bytes()
    return text + b"".join(_source_bytes(CSRC / inc.decode(), seen)
                           for inc in _LOCAL_INCLUDE.findall(text))


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Built]:
    """Build the named sources (default: all), one ``nvcc`` per source, all
    started together; returns each library's path, build time and log."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    done = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.is_file():
            done[name] = Built(out, 0.0, log.read_text() if log.is_file() else "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    for name, (proc, tmp, out, log, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{text}")
        log.write_text(text)
        os.replace(tmp, out)
        done[name] = Built(out, seconds, text)
    return done


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, built and loaded once."""
    fn = _loaded.get(name)
    if fn is None:
        source, entry, argtypes = KERNELS[name]
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build([source])[source].path))
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check_args(q_n: int, **args) -> None:
    """Validate a launch's tensors before their pointers go to C.  Each
    ``args[name]`` is ``(tensor, shape)`` (``shape`` None: any) and must be
    a contiguous int32 CUDA tensor of that shape with fewer than 2**31
    elements (the kernels index with int32 offsets); ``q_n`` queries must
    fit the grid's y extent."""
    for name, (x, shape) in args.items():
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if x.dtype != torch.int32 or not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 CUDA tensor, "
                             f"got {x.dtype} on {x.device}")
        if x.numel() >= 2**31:
            raise ValueError(f"{name}: {x.numel()} elements need int64 offsets")
    if q_n >= 65536:
        raise ValueError(f"{q_n} queries exceed the grid's y extent (65535)")


def check_aligned(**arrays) -> None:
    """Raise unless each array (None: skipped) starts on 16 bytes and holds
    a whole number of 16-byte chunks: the bulk copies of
    ``csrc/probe_async.cuh`` move whole chunks, rounding a range's ends out
    to them, and stay inside such an array."""
    for name, x in arrays.items():
        if x is None:
            continue
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: starts at {x.data_ptr():#x}; the probe's "
                             "bulk copies need 16-byte alignment")
        if x.numel() * x.element_size() % 16:
            raise ValueError(f"{name}: {x.numel()} elements of {x.element_size()} "
                             "bytes; the probe's bulk copies need a multiple of 16 "
                             "bytes")


def packed_args(packed, label: str = "") -> dict:
    """:func:`check_args` entries of a block-codec twin's four arrays
    (``repro_torch.core.index.PackedFlatArrays``), names prefixed by
    ``label``; the descriptor lengths follow from ``n_blocks``."""
    desc = packed.blk_base.shape[0]
    return {f"{label}words": (packed.words, None),
            f"{label}blk_base": (packed.blk_base, (desc,)),
            f"{label}blk_meta": (packed.blk_meta, (desc,)),
            f"{label}blk_woff": (packed.blk_woff, (desc + 1,))}


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
