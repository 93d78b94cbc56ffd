"""Copy of `jpeg_decoder_tpu/entropy/native.py` at commit 0c2d0ea.

ctypes loader for the C++ host entropy kernel.

The native engine lives in `cpp/entropy.cc` and is compiled on demand with g++
(no pip dependencies). Until it is built — or if a compiler is unavailable —
`get_native()` returns None and callers fall back to the Python oracle.
"""

from __future__ import annotations

import os

_native = None
_attempted = False


def get_native():
    """Return the native engine module-like object, or None if unavailable."""
    global _native, _attempted
    if _attempted:
        return _native
    _attempted = True
    if os.environ.get("JPEG_TPU_DISABLE_NATIVE"):
        return None
    try:
        from . import native_impl
        _native = native_impl if native_impl.available() else None
    except Exception:
        _native = None
    return _native


def reset_native_cache() -> None:
    global _native, _attempted
    _native = None
    _attempted = False
