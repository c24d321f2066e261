"""Native (C) host-path components, loaded via ctypes with pure-Python
fallbacks. Build with native/build.sh (attempted automatically on first
import)."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libhashtok.so")
_lib = None
_build_attempted = False


def get_miniredis_path():
    """Path to the miniredis server binary (building if needed); None if the
    toolchain is unavailable. Callers spawn it as a subprocess."""
    global _build_attempted
    path = os.path.join(_DIR, "miniredis")
    src = os.path.join(_DIR, "miniredis.cc")
    stale = (os.path.exists(path) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(path))
    if os.path.exists(path) and not stale:
        return path
    if not _build_attempted:
        _build_attempted = True
        try:
            subprocess.run(["bash", os.path.join(_DIR, "build.sh")],
                           capture_output=True, check=True, timeout=120)
        except Exception as e:
            logger.debug("native build unavailable: %s", e)
    return path if os.path.exists(path) else None


_front_lib = None


def get_httpfront_lib():
    """Load (building if needed) the native HTTP front library; None if the
    toolchain is unavailable — callers fall back to the asyncio-only surface."""
    global _front_lib, _build_attempted
    if _front_lib is not None:
        return _front_lib
    path = os.path.join(_DIR, "libhttpfront.so")
    if not os.path.exists(path) and not _build_attempted:
        _build_attempted = True
        try:
            subprocess.run(["bash", os.path.join(_DIR, "build.sh")],
                           capture_output=True, check=True, timeout=120)
        except Exception as e:
            logger.debug("native build unavailable: %s", e)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        # drain-record wire format is shared with api/native_front.py's
        # struct unpack — a stale .so (built before a format bump, or
        # missing the version export entirely) must be rebuilt, not loaded
        abi = (lib.httpfront_abi_version()
               if hasattr(lib, "httpfront_abi_version") else 0)
        if abi != 2:
            logger.info("native front ABI %d != 2; rebuilding", abi)
            del lib
            # unlink first: the compiler truncates in place (same inode) and
            # dlopen caches by inode, so an in-place rebuild could hand back
            # the stale mapping; a fresh inode guarantees a fresh load
            os.remove(path)
            try:
                subprocess.run(["bash", os.path.join(_DIR, "build.sh")],
                               capture_output=True, check=True, timeout=120)
                lib = ctypes.CDLL(path)
            except Exception as e:
                # no toolchain on this host: fall back to the asyncio surface only
                # rather than crashing startup on the rebuild attempt
                logger.warning("native front rebuild failed: %s", e)
                return None
            if (not hasattr(lib, "httpfront_abi_version")
                    or lib.httpfront_abi_version() != 2):
                logger.warning("native front ABI still stale after rebuild")
                return None
        lib.httpfront_start.restype = ctypes.c_int
        lib.httpfront_start.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.httpfront_stop.restype = None
        lib.httpfront_stop.argtypes = []
        lib.httpfront_drain.restype = ctypes.c_int
        lib.httpfront_drain.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.httpfront_complete.restype = None
        lib.httpfront_complete.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_char_p, ctypes.c_int]
        lib.httpfront_stats.restype = None
        lib.httpfront_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.httpfront_id_prefix.restype = ctypes.c_int
        lib.httpfront_id_prefix.argtypes = [ctypes.c_char_p, ctypes.c_int]
        _front_lib = lib
        return _front_lib
    except OSError as e:
        logger.debug("native front lib load failed: %s", e)
        return None


def get_hashtok_lib():
    """Load (building if needed) the native tokenizer library; None if
    unavailable — callers fall back to pure Python."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build_attempted:
        _build_attempted = True
        try:
            subprocess.run(["bash", os.path.join(_DIR, "build.sh")],
                           capture_output=True, check=True, timeout=60)
        except Exception as e:
            logger.debug("native build unavailable: %s", e)
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.hashtok_encode.restype = ctypes.c_int
        lib.hashtok_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib
    except OSError as e:
        logger.debug("native lib load failed: %s", e)
        return None
