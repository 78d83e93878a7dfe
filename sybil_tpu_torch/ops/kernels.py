"""Build, load and count the package's CUDA kernels.

Each `csrc/<name>.cu` holds one kernel family behind a plain C entry
point.  It is compiled by `nvcc` for `sm_90a` into its own shared
library on first use, named by the hash of its source (with the shared
headers of csrc/) and flags, into
`csrc/build/` (listed in .gitignore), and loaded with ctypes.  Sources
are compiled in parallel, one `nvcc` process each.  Importing this
module builds nothing: the first wrapper call on a CUDA tensor does.

LAUNCHES counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else, so a caller can reset
the counts, drive a query and read which kernels the query ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

SOURCES = ("decode_bucket2", "decode_value", "dense_scan", "dense_hist",
           "outlier_compact", "dense_pack", "sorted_front", "segment_reduce",
           "hist_pairs", "sorted_pack", "enum_segments", "topk_rows",
           "hll_registers", "set_match", "shuffle_partition",
           "shuffle_reduce")
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the wrappers that launch a source's other kernels: sort_permute
# (sorted_front.cu), enum_pack (sorted_pack.cu), hist_prep (K9's first
# entry, hist_pairs.cu), shuffle_keys and
# shuffle_unpack (shuffle_reduce.cu), and the entry of dense_pack.cu's
# keyed form of a scan's own table (dense_keyed: the row-store scan's),
# counted apart from its other forms; and the device prune's gather, which
# K12's one launch runs after its select (topk_rows.cu, prune_topk_gather)
ENTRY_SOURCES = {"sort_permute": "sorted_front", "enum_pack": "sorted_pack",
                 "hist_prep": "hist_pairs", "prune_gather": "topk_rows",
                 "shuffle_keys": "shuffle_reduce",
                 "shuffle_unpack": "shuffle_reduce",
                 "dense_keyed": "dense_pack"}
# one count per wrapper: a source's name, and each entry above
LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES + tuple(ENTRY_SOURCES)}
# K2's, K4's and K13's launches split by form, and K6's by mode: each
# wrapper adds one to LAUNCHES and one here where it launches
FORMS: dict[str, int] = {"dense_scan shared or resident": 0,
                         "dense_scan global": 0, "dense_scan windowed": 0,
                         "dense_hist shared": 0, "dense_hist global": 0,
                         "hll_registers shared": 0,
                         "hll_registers global": 0,
                         "decode_value values": 0, "decode_value ids": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, FORMS):
        for k in counts:
            counts[k] = 0


class Launches(dict):
    """A copy of LAUNCHES; `forms` holds a copy of FORMS taken with it.
    It compares as the plain dict of counts."""
    forms: dict


def snapshot() -> Launches:
    """The launch counts since the last reset_launches, by form in
    `.forms`."""
    got = Launches(LAUNCHES)
    got.forms = dict(FORMS)
    return got


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit (set NVCC to its path)")


def _so_path(name: str) -> str:
    """The library's path, named by the hash of its source, the shared
    headers of csrc/ and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                      if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fn), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    nvcc processes at once.  Returns {name: library path}; raises with
    the compiler's output when any build fails.  ptxas's register and
    shared-memory report lands beside each library as `<name>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _so_path(n) for n in names}
    procs = {}
    for n, so in paths.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, n + ".log"), "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n"
                          + out.decode(errors="replace"))
            continue
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _LOCK:
        handle = _LIBS.get(name)
        if handle is None:
            handle = _LIBS[name] = ctypes.CDLL(build((name,))[name])
        return handle


def entry(name: str, fn: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point `fn` of source `name`'s library, its argtypes
    and restype (default cudaError_t as int) set once a loaded library
    rather than on every call."""
    handle = lib(name)
    got = _ENTRIES.get((name, fn))
    if got is None or got[0] is not handle:
        f = getattr(handle, fn)
        f.argtypes, f.restype = argtypes, restype
        got = _ENTRIES[(name, fn)] = (handle, f)
    return got[1]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(name: str):
    """The torch device a query runs on.  "cuda" (the default) needs a
    card and raises without one; the CPU is used only when asked for."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass -device cpu (Flags.device='cpu') to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on `device`, read
    without building a torch.cuda.Stream object (which costs several
    microseconds of host time a launch)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
