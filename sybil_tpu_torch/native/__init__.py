"""Native runtime components.

walcodec: a C++ decoder for the row-store WAL (JSON-lines of typed
records) that pivots straight into columnar arrays with per-column
interned dictionaries — the native data-loader replacing the reference's
row-store decode hot loop (src/lib/row_store.go:68, table_ingest.go:125).

Built on demand with g++ (no pip deps); every entry point degrades to
the pure-Python decoder when the toolchain or build is unavailable, so
the native layer is a pure accelerator, never a requirement.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

_mod = None
_tried = False


def _load():
    global _mod, _tried
    if _tried:
        return _mod
    _tried = True
    if os.environ.get("SYBIL_NO_NATIVE"):
        return None
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "walcodec.cpp")
        with open(src, "rb") as f:
            tag = hashlib.md5(f.read()).hexdigest()[:12]
        build = os.path.join(here, "build")
        so = os.path.join(build, f"_walcodec_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(build, exist_ok=True)
            inc = sysconfig.get_paths()["include"]
            tmp = f"{so}.tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 f"-I{inc}", src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic publish, racing builders converge
        spec = importlib.util.spec_from_file_location("_walcodec", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception as e:  # noqa: BLE001 - any failure means "no native"
        from ..debug import debug
        debug("native walcodec unavailable:", e)
        _mod = None
    return _mod


def available() -> bool:
    return _load() is not None


def parse_wal_bytes(data: bytes):
    """-> raw columnar dict (see walcodec.cpp) or None for fallback."""
    mod = _load()
    if mod is None:
        return None
    try:
        return mod.parse(data)
    except Exception:  # noqa: BLE001 - corrupt input -> Python fallback
        return None
