"""Native (C++) host components, loaded via ctypes with Python fallback.

The reference's runtime is entirely native Fortran (SURVEY.md section 2);
this package holds the framework's native host equivalents. Currently:

  ace_tokenizer  whitespace-float tokenization of ACE ASCII tables
                 (the host-parse hot path at library scale)

The shared library is built from ace_tokenizer.cpp with g++ on first use,
and rebuilt whenever the source is newer than the library; it is never
committed. A failed build logs one warning and the numpy path runs; set
NDPP_TPU_NO_NATIVE=1 to force the numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "ace_tokenizer.cpp"
_LIB_PATH = _HERE / "libndpp_native.so"
_lib: ctypes.CDLL | None = None
_tried = False


def _warn(msg: str, *args) -> None:
    from ndpp_tpu.utils import log as log_mod

    log_mod.get().warning("native tokenizer: " + msg + "; using the numpy path", *args)


def _stale() -> bool:
    return not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime


def _build() -> bool:
    # build beside the target, then rename: a concurrent process never sees
    # a half-written library
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _warn("build failed (%s: %s)", type(e).__name__, detail.decode(errors="replace")[:500])
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("NDPP_TPU_NO_NATIVE"):
        return _lib
    _tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.ndpp_tokenize.restype = ctypes.c_longlong
        lib.ndpp_tokenize.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ndpp_count_tokens.restype = ctypes.c_longlong
        lib.ndpp_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
    except OSError as e:
        _warn("load failed (%s)", e)
        _lib = None
    return _lib


def tokenize_floats(text: str | bytes, expected: int | None = None) -> np.ndarray:
    """All whitespace-separated floats in `text` as float64 (native or numpy path)."""
    data = text.encode() if isinstance(text, str) else text
    lib = get_lib()
    if lib is not None:
        cap = expected if expected is not None else int(lib.ndpp_count_tokens(data, len(data)))
        out = np.empty(cap, dtype=np.float64)
        consumed = ctypes.c_size_t(0)
        n = lib.ndpp_tokenize(
            data,
            len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
            ctypes.byref(consumed),
        )
        if n >= 0:
            return out[:n]
        # fall through to the numpy path on parse errors (error reporting there)
    return np.array(data.split(), dtype=np.float64)
