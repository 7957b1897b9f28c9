"""ctypes bindings for the C++ TFRecord reader (``native/tfrecord_reader.cc``).

The port's counterpart of the JAX package's ``data/native_reader.py``:
``read_examples_native`` returns the same ``{name: (kind, values)}``
structure as the pure-Python codec in ``tfrecord.py``, ``crc32c_native``
is the record checksum.  The library is built from the checkout's
``native/tfrecord_reader.cc`` at first use, with ``g++ -O2 -fPIC -shared
-std=c++17``, into ``build/native/`` at the root of the checkout, under a
name that carries a hash of the source and the flags (the scheme of
``ops/cuda_build.py``); an unchanged source reuses the library, an edited
one is rebuilt.  No prebuilt library is ever loaded.

``available()`` is False only where no C++ compiler is found (the reason
is ``unavailable_reason()``); a compiler that fails on the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "tfrecord_reader.cc"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_missing: Optional[str] = None


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtfrecord_reader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library if this source has none yet; returns its path.
    Raises when the compiler fails (or is missing)."""
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    v, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tfr_open.restype = v
    lib.tfr_open.argtypes = [ctypes.c_char_p]
    lib.tfr_close.argtypes = [v]
    lib.tfr_num_examples.argtypes = [v]
    lib.tfr_num_fields.argtypes = [v, i]
    lib.tfr_field_name.restype = ctypes.c_char_p
    lib.tfr_field_name.argtypes = [v, i, i]
    lib.tfr_field_kind.argtypes = [v, i, i]
    lib.tfr_field_count.argtypes = [v, i, i]
    lib.tfr_bytes_len.restype = i64
    lib.tfr_bytes_len.argtypes = [v, i, i, i]
    lib.tfr_bytes_data.restype = v
    lib.tfr_bytes_data.argtypes = [v, i, i, i]
    lib.tfr_float_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.tfr_float_data.argtypes = [v, i, i]
    lib.tfr_int64_data.restype = ctypes.POINTER(ctypes.c_int64)
    lib.tfr_int64_data.argtypes = [v, i, i]
    lib.tfr_crc32c.restype = ctypes.c_uint32
    lib.tfr_crc32c.argtypes = [ctypes.c_char_p, i64]
    return lib


def _load_library() -> ctypes.CDLL:
    global _lib, _missing
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _compiler() is None and not library_path().exists():
                _missing = "no C++ compiler (g++ or c++) on PATH"
                raise OSError(_missing)
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def available() -> bool:
    """True when the library is built (building it now if need be); False
    only without a C++ compiler.  A failed build raises."""
    try:
        _load_library()
        return True
    except OSError:
        if _missing is None:
            raise
        return False


def unavailable_reason() -> Optional[str]:
    """Why the native reader does not serve, or None when it does."""
    return None if available() else _missing


def crc32c_native(data: bytes) -> int:
    return _load_library().tfr_crc32c(bytes(data), len(data))


def _array(ptr, count: int, dtype) -> list:
    if count == 0:
        return []
    return np.ctypeslib.as_array(ptr, (count,)).astype(dtype).tolist()


def read_examples_native(path: str) -> Iterator[Dict[str, tuple]]:
    """Every Example of the file (its CRCs verified by the library; a
    corrupt or truncated record raises IOError)."""
    lib = _load_library()
    handle = lib.tfr_open(os.fsencode(path))
    if not handle:
        raise IOError(f"failed to read TFRecord: {path}")
    try:
        kinds = {0: "bytes", 1: "float", 2: "int64"}
        examples = []
        for e in range(lib.tfr_num_examples(handle)):
            example: Dict[str, tuple] = {}
            for f in range(lib.tfr_num_fields(handle, e)):
                name = lib.tfr_field_name(handle, e, f).decode("utf-8")
                kind = kinds[lib.tfr_field_kind(handle, e, f)]
                count = lib.tfr_field_count(handle, e, f)
                if kind == "bytes":
                    values = [ctypes.string_at(
                        lib.tfr_bytes_data(handle, e, f, k),
                        lib.tfr_bytes_len(handle, e, f, k))
                        for k in range(count)]
                elif kind == "float":
                    values = _array(lib.tfr_float_data(handle, e, f), count,
                                    np.float32)
                else:
                    values = _array(lib.tfr_int64_data(handle, e, f), count,
                                    np.int64)
                example[name] = (kind, values)
            examples.append(example)
    finally:
        lib.tfr_close(handle)
    yield from examples
