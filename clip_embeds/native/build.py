"""Lazy g++ build + ctypes loader for the native runtime library."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["resize.cpp", "decode.cpp"]
_LIB_NAME = "libclip_embeds_native.so"
# (define, header, library) of the codecs compiled in where their headers
# exist; without one, its format falls back to PIL. PNG needs only zlib.
_OPTIONAL_CODECS = [
    ("CLIP_HAVE_JPEG", "jpeglib.h", "-ljpeg"),
    ("CLIP_HAVE_WEBP", "webp/decode.h", "-lwebp"),
]


def _has_header(header: str) -> bool:
    probe = subprocess.run(
        ["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
        input=f"#include <{header}>\n", capture_output=True, text=True,
    )
    return probe.returncode == 0


def _build(lib_path: str, optional_codecs=_OPTIONAL_CODECS) -> None:
    sources = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    flags, libs = [], ["-lz"]
    for define, header, lib in optional_codecs:
        if _has_header(header):
            flags.append(f"-D{define}")
            libs.append(lib)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", *flags, "-o", lib_path, *sources, *libs,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of the library's C ABI."""
    lib.resize_normalize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.resize_normalize_one.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.decode_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.decode_preprocess_batch.restype = ctypes.c_int
    lib.probe_image.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.probe_image.restype = ctypes.c_int
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (once) and dlopen the native library; None if unavailable."""
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        lib_path = os.path.join(_SRC_DIR, _LIB_NAME)
        try:
            newest_src = max(
                os.path.getmtime(os.path.join(_SRC_DIR, s)) for s in _SOURCES
            )
            if (not os.path.exists(lib_path)
                    or os.path.getmtime(lib_path) < newest_src):
                _build(lib_path)
            try:
                lib = ctypes.CDLL(lib_path)
            except OSError:  # built on another host against other codecs
                _build(lib_path)
                lib = ctypes.CDLL(lib_path)
            lib = _declare(lib)
            _LIB = lib
        except Exception as exc:  # pragma: no cover
            logging.warning("native library unavailable (%s); using PIL path",
                            exc)
            _FAILED = True
    return _LIB
