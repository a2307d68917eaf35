"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Every ``.cu`` source compiles to an object with its own ``nvcc`` process,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  Nothing includes PyTorch's
headers, so a cold build takes seconds.  The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash of the sources and flags: an
edited source rebuilds, an unchanged one loads the library already built.

Nothing here runs at import time; the first CUDA launch calls :func:`lib`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[3] / "build" / "repro_torch_kernels"
# no --use_fast_math and no -ftz=true: flushing denormals would change
# comparisons against them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

#: kernel name -> launches since the last reset; each wrapper adds one
#: right after it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {"predicate_scan": 0, "bitmap_setop": 0,
                            "fused_chain_scan": 0, "dict_lookup_scan": 0,
                            "predicate_scan_multi": 0,
                            "dict_lookup_scan_multi": 0,
                            "bitmap_inter_multi": 0,
                            "bitmap_union_reduce": 0,
                            "bitmap_setop_grouped": 0}

#: stacked kernel name -> Q (record sets per launch) -> launches since the
#: last reset; each stacked wrapper adds one beside its LAUNCHES count
LAUNCHES_BY_Q: Dict[str, Counter] = {
    k: Counter() for k in ("predicate_scan_multi", "dict_lookup_scan_multi",
                           "bitmap_inter_multi", "bitmap_union_reduce")}

_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # col, bits, pops_in, value, opcode, n, w, out, pops_out, stream
    "rt_predicate_scan": [_P, _P, _P, _F, _I, _I, _I, _P, _P, _P],
    # the same with the value's device address
    "rt_predicate_scan_dv": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # a, a_pops, b, b_pops, opcode, n, w, out, pops_out, stream
    "rt_bitmap_setop": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # col_ptrs, values, opcodes, k, conj, bits, pops_in, n, w, out,
    # pops_out, stream (the table on the device; _small: on the host;
    # _small_dv: on the host but the values on the device)
    "rt_fused_chain_scan": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "rt_fused_chain_scan_small": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
                                  _P],
    "rt_fused_chain_scan_small_dv": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P,
                                     _P, _P],
    # col, bits, pops_in, mask, u, n, w, out, pops_out, stream
    "rt_dict_lookup_scan": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # col, bits, pops_in, value, opcode, q, n, w, out, pops_out, stream
    "rt_predicate_scan_multi": [_P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P],
    # col, bits, pops_in, mask, u, q, n, w, out, pops_out, stream
    "rt_dict_lookup_scan_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                  _P],
    # host_rows (q (bits, pops) int64 address pairs), q, a, a_pops, n, w,
    # out, pops_out, stream
    "rt_bitmap_inter_multi": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
    # host_rows, q, n, w, accumulate, stack, stack_pops, out, pops_out,
    # stream
    "rt_bitmap_union_reduce": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # table, g, n, w, stream
    "rt_bitmap_setop_grouped": [_P, _I, _I, _I, _P],
}
#: entries that load the tape path's kernels (and the set operations') at
#: once: a CUDA graph capture must not be a kernel's first use
_LOADERS = ("rt_load_predicate_scan", "rt_load_bitmap_setop",
            "rt_load_fused_chain", "rt_load_dict_lookup")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_q in LAUNCHES_BY_Q.values():
        by_q.clear()


def count_launch(name: str, q: Optional[int] = None) -> None:
    """Count one launch of kernel ``name`` (of ``q`` stacked record sets,
    for a stacked kernel)."""
    LAUNCHES[name] += 1
    if q is not None:
        LAUNCHES_BY_Q[name][q] += 1


def take_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a copy of :data:`LAUNCHES`),
    which are taken back out of :data:`LAUNCHES`.  A CUDA graph's capture
    runs the wrappers, which count their kernels, but launches nothing; its
    replays launch them, and :func:`add_launches` counts them there."""
    delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    LAUNCHES.update({k: before.get(k, 0) for k in LAUNCHES})
    return {k: v for k, v in delta.items() if v}


def add_launches(delta: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    for k, v in delta.items():
        LAUNCHES[k] += v


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from src/repro_torch/kernels/csrc at "
                           "first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def library_path() -> Path:
    """Where the library of these exact sources and flags is built (it
    may not exist yet)."""
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Build the shared library unless a build of these exact sources and
    flags exists; returns its path.  Safe under concurrent callers."""
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    target = library_path()
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target
        exe = nvcc()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
            _run_all([[exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                       "-o", str(obj)]
                      for src, obj in zip(sources(), objs)])
            staged = Path(tmp) / target.name
            _run_all([[exe, *NVCC_FLAGS, "-shared", *map(str, objs),
                       "-o", str(staged)]])
            os.replace(staged, target)
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in _LOADERS:
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = [], ctypes.c_int
            check(fn(), name)
        _LIB = handle
    return _LIB


def expect(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what every kernel's C entry point assumes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: 32-bit words of dynamic shared memory a block may take without opting
#: in to more (48 KiB)
MAX_SHARED_WORDS = 48 * 1024 // 4


def expect_shared_words(w: int, name: str) -> None:
    """Raise unless a block's W hit words fit the lockstep kernels' shared
    memory (B = 32·W records per block, up to 393,216)."""
    if w > MAX_SHARED_WORDS:
        raise ValueError(f"{name}: {w} words per block exceed the "
                         f"{MAX_SHARED_WORDS} that fit in shared memory")


def expect_aligned16(t, name: str) -> None:
    """Raise unless ``t`` starts 16-byte aligned (the compare-and-pack
    step loads 4 records at a time)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                         "loads 4 records at a time)")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch (or
    its kernels' loading)."""
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}: kernel {name} failed to "
                           "launch")
