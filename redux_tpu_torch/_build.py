"""Build and load the port's CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` of the package for
Hopper (``sm_90a``), one process a source, all started together, and
links the objects into one shared library with a plain C interface.
The library lands in ``build/redux_tpu_torch/`` beside the package, named
by a hash of the sources and flags, so an edited source rebuilds.  It is
loaded with ``ctypes``: every pointer and the stream pass as ``c_void_p``,
ints as ``c_int`` (``c_longlong`` for a byte count), and every C entry returns ``cudaGetLastError()``, on
which :func:`check` raises.  A failed build or launch raises; nothing
falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "redux_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers, spills and shared memory, kept
# beside the library (resource_usage).
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name -> argument types (all return int = cudaError_t).
SIGNATURES = {
    # syms, lens, init_cum, lo, hi, B, K, delta, freq_max, device, stream
    "rxt_model_lohi": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # lo, hi, lens, words, byte_lens, ovf, B, K, n_words, init_total,
    # tfreeze, delta, code_bits, fits53, device, stream
    "rxt_encode_blocks": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # words, lens, init_cum, out, B, W, k, delta, freq_max, code_bits,
    # fits53, warp, device, stream
    "rxt_decode_blocks": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # syms, lens, init_cum, words, byte_lens, ovf, B, K, n_words, delta,
    # freq_max, code_bits, device, stream (K4 and K5 take the same)
    "rxt_encode_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rxt_encode_m": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # buf, n, offs, lens, out, B, row bytes, words, device, stream
    "rxt_gather_rows": (_P, _L, _P, _P, _P, _L, _L, _I, _I, _P),
    # words, n_words, blocks, k, B, ends, raw, out, total, device, stream
    "rxt_splice_payload": (_P, _I, _P, _I, _L, _P, _P, _P, _L, _I, _P),
    # buf, n, consts, out, device, stream
    "rxt_crc32": (_P, _L, _P, _P, _I, _P),
    # buf, n, out, device, stream
    "rxt_byte_histogram": (_P, _L, _P, _I, _P),
}

_lib = None
_lock = threading.Lock()
card_launches: collections.Counter = collections.Counter()  # (kernel, device index) -> launches
route_blocks: collections.Counter = collections.Counter()  # (K3 route, device index) -> blocks
bus_bytes: collections.Counter = collections.Counter()  # "h2d" / "d2h" -> bytes over the bus


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else ``PATH``)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_version() -> str:
    out = subprocess.run([nvcc(), "--version"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libredux_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [Path(objdir) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen([cc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(_sources(), objs)
        ]
        errors, reports = [], []
        for src, proc in zip(_sources(), procs):
            so, se = proc.communicate()  # waits: no compiler outlives the build
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{se}")
            reports.append(f"== {src.name}\n{so}{se}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        _report_path(out).write_text("\n".join(reports))
        link = [cc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def _report_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


def _kernel_name(mangled: str) -> str:
    """``decode_kernel<true>`` from its mangled name (length-prefixed
    identifiers; a bool template argument is ``ILb0E``/``ILb1E``)."""
    for m in re.finditer(r"(?=(\d+))", mangled):  # every start: "d719model_..." holds 19
        start = m.start() + len(m.group(1))
        ident = mangled[start : start + int(m.group(1))]
        if ident.endswith("_kernel"):
            arg = mangled[start + len(ident) :]
            return ident + {"ILb0E": "<false>", "ILb1E": "<true>"}.get(arg[:5], "")
    return mangled


def resource_usage() -> list[str]:
    """One line a kernel entry from ptxas's report of the build: source,
    kernel (with its template argument), registers, shared memory and
    spills."""
    lines, src, name, spill = [], "", None, ""
    for line in _report_path(build()).read_text().splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif m := re.search(r"entry function '(\S+)'", line):
            name, spill = _kernel_name(m.group(1)), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            lines.append(f"{src} {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.rxt_error_string.argtypes = [ctypes.c_int]
            handle.rxt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib().rxt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def count_launch(kernel: str, device: torch.device) -> None:
    """One launch of ``kernel`` on ``device`` into :data:`card_launches`,
    which ``redux_tpu_torch.launch_counts`` reads: each wrapper calls it
    where it launches its kernel, and nowhere else."""
    card_launches[kernel, device.index or 0] += 1


def count_blocks(route: str, device: torch.device, n: int) -> None:
    """``n`` blocks decoded by K3's ``route`` (``"warp"`` or ``"thread"``)
    on ``device`` into :data:`route_blocks`, which ``api``'s recorder
    reads: K3's wrapper calls it beside its :func:`count_launch`."""
    route_blocks[route, device.index or 0] += n


def count_bus(h2d: int = 0, d2h: int = 0) -> None:
    """Bytes copied to (``h2d``) and from (``d2h``) a device into
    :data:`bus_bytes`, which ``api``'s recorder reads: each copy between
    the host and a device calls it where it copies, and the plain CPU
    versions where they stand in for such a copy."""
    bus_bytes["h2d"] += h2d
    bus_bytes["d2h"] += d2h


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
