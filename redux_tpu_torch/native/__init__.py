"""The native sequential codec (host code, C++ through ctypes).

Counterpart: ``redux_tpu/native/__init__.py`` — ``compress_bytes``,
``decompress_bytes``, ``compress_block_v2`` and ``decompress_block_v2``
over the C entries ``rdx_compress``, ``rdx_decompress``,
``rdx_compress_v2`` and ``rdx_decompress_v2`` of ``redux_native.cpp`` (the
port's own copy).  The fast host path for reference-format streams and
the compact archive's single v2 block, byte-identical to
:mod:`redux_tpu_torch.oracle`.

At first use ``g++ -O3`` builds the library into ``build/redux_tpu_torch/``
beside the package, named by a hash of the source, the compiler and the
flags, so an edited source rebuilds.  There is no ``-march``: the build
directory may travel to another machine, where a library tuned for this
CPU could load under the same name and die on an illegal instruction;
the bytes do not depend on it.  Each process compiles to a name of its
own and renames the result into place, so concurrent builders (test
workers) never see a partial file.  A failed build raises
:class:`NativeUnavailable`; nothing falls back to the oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD_DIR
from ..errors import EofError, InvalidInputError
from ..params import Parameters

SOURCE = Path(__file__).resolve().parent / "redux_native.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points: name -> argument types (all return int64: the byte count,
# or -1 for a codec error, -2 for an output buffer too small).
SIGNATURES = {
    # in, n, out, cap, symbol_bits, freq_bits, code_bits, prior extra
    "rdx_compress": (ctypes.c_char_p, _I64, _P, _I64, _I, _I, _I, _P),
    # ... and nsyms (-1: decode to the EOF symbol)
    "rdx_decompress": (ctypes.c_char_p, _I64, _P, _I64, _I, _I, _I, _P, _I64),
    # ... and delta
    "rdx_compress_v2": (ctypes.c_char_p, _I64, _P, _I64, _I, _I, _I, _P, _I64),
    # ... and delta, nsyms
    "rdx_decompress_v2": (ctypes.c_char_p, _I64, _P, _I64, _I, _I, _I, _P, _I64, _I64),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libredux_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for this source and these flags exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        raise NativeUnavailable(f"native build failed ({' '.join(cmd)}): {detail}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError as e:
                raise NativeUnavailable(f"native library failed to load: {e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int64
            _lib = handle
        return _lib


def _prior_ptr(prior_extra):
    """The u16 prior table and its pointer (kept alive by the caller), or Nones."""
    if prior_extra is None:
        return None, None
    arr = np.ascontiguousarray(prior_extra, dtype=np.uint16)
    if arr.shape != (256,):
        raise InvalidInputError("the prior table holds 256 counts")
    return arr, arr.ctypes.data_as(ctypes.c_void_p)


def compress_bytes(
    data: bytes, params: Optional[Parameters] = None, prior_extra=None
) -> bytes:
    """Reference-format compress (byte-identical to the reference CLI)."""
    p = params or Parameters.default()
    lib = get_lib()
    cap = len(data) * 2 + 4096 + len(data) // 2
    out = np.empty(cap, dtype=np.uint8)
    _arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_compress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
        p.symbol_bits, p.freq_bits, p.code_bits, ptr,
    )
    if n < 0:
        raise InvalidInputError()
    return out[:n].tobytes()


def compress_block_v2(
    data: bytes, params: Parameters, prior_extra=None, delta: int = 1
) -> bytes:
    """One RXT v2 block payload (:func:`redux_tpu_torch.oracle.compress_block`'s bytes)."""
    lib = get_lib()
    cap = len(data) * 2 + 4096 + len(data) // 2
    out = np.empty(cap, dtype=np.uint8)
    _arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_compress_v2(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
        params.symbol_bits, params.freq_bits, params.code_bits, ptr, delta,
    )
    if n < 0:
        raise InvalidInputError()
    return out[:n].tobytes()


def decompress_block_v2(
    payload: bytes, n_symbols: int, params: Parameters, prior_extra=None,
    delta: int = 1,
) -> bytes:
    """Decode one RXT v2 block payload of ``n_symbols`` bytes."""
    lib = get_lib()
    out = np.empty(max(n_symbols, 1), dtype=np.uint8)
    _arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_decompress_v2(
        payload, len(payload), out.ctypes.data_as(ctypes.c_void_p),
        max(n_symbols, 1), params.symbol_bits, params.freq_bits,
        params.code_bits, ptr, delta, n_symbols,
    )
    if n < 0:
        raise EofError() if n == -1 else InvalidInputError()
    return out[:n].tobytes()


def decompress_bytes(
    data: bytes,
    params: Optional[Parameters] = None,
    prior_extra=None,
    nsyms: int = -1,
    max_out: Optional[int] = None,
) -> bytes:
    """Reference-format decompress; ``nsyms >= 0`` decodes exactly that many
    symbols (stored-length termination)."""
    p = params or Parameters.default()
    lib = get_lib()
    cap = max_out if max_out is not None else max(len(data) * 8 + 4096, 1 << 20)
    # Growth is bounded: a valid stream carries at most ~freq_max / 256
    # symbols a bit, and the allocation stops at 4 GiB, so a crafted stream
    # fails with InvalidInputError instead of forcing unbounded allocations.
    hard_cap = min(max(len(data), 1) * 4096 + (1 << 20), 4 << 30)
    _arr, ptr = _prior_ptr(prior_extra)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.rdx_decompress(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
            p.symbol_bits, p.freq_bits, p.code_bits, ptr, nsyms,
        )
        if n == -1:
            raise EofError()
        if n == -2:  # more output than the guess: grow and retry
            if max_out is not None or cap >= hard_cap:
                raise InvalidInputError()
            cap = min(cap * 8, hard_cap)
            continue
        return out[:n].tobytes()
