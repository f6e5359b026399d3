"""Shared loader for the C++ helpers in native/ (built on demand via
make, loaded with ctypes).  One module-level lock serializes first-use
builds across threads; per-library failure latches keep a missing
toolchain from being retried on every call.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict, Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def load_native_lib(name: str,
                    configure: Callable[[ctypes.CDLL], None]
                    ) -> Optional[ctypes.CDLL]:
    """Build (make -C native) and load build/<name>.so; None on failure.

    ``configure`` sets argtypes/restype once on first successful load.
    """
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            # make is a freshness no-op when the .so is current and
            # rebuilds after any source change
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
            lib = ctypes.CDLL(os.path.join(_NATIVE_DIR, "build",
                                           f"{name}.so"))
            configure(lib)
        except Exception:
            lib = None
        _libs[name] = lib
        return lib
