"""The one generator of the benchmark's inputs: a traffic mix's files, made
from the seed with torch integer arithmetic on one device.

A traffic mix (``benchmark/traffic/<name>.json``) lists files, each with
a name, a size in bytes and a content kind.  A kind is a file of its own,
``benchmark/content/<kind>.py``, whose ``fill(out, seed)`` writes the
bytes of ``seed`` into ``out`` (a uint8 tensor on its device); the
generator finds it by name, so a new kind goes in as a new file.

``text_like``, ``mixed`` and ``incompressible`` are the splitmix64-counter
streams of the program's own test inputs (``redux_tpu_torch/testdata.py``),
copied so that the inputs stay fixed whatever later changes make to the
program: the same seed gives the same bytes.  Every draw is made on the
device (the card in a run: about 20 ms a GiB, where numpy takes 20 s)
and the bytes come back once into a ``bytes`` object.  uint64 arithmetic
is int64 arithmetic with wrapping products and a masked right shift.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

CONTENT = Path(__file__).resolve().parent / "content"

_GOLDEN = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB

# Draws a segment: the transients stay under 1 GiB of device memory.
DRAWS = 1 << 23


class File(NamedTuple):
    name: str
    data: bytes


def _i64(v: int) -> int:
    """The int64 with the bits of the uint64 ``v mod 2**64``."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(seed: int, n: int, start: int, device) -> torch.Tensor:
    """``n`` splitmix64 values (int64 bit patterns) of counters
    ``seed * 2**32 + start + i``."""
    z = torch.arange(start, start + n, dtype=torch.int64, device=device)
    z = z + _i64(seed << 32)
    z = z * _i64(_GOLDEN) + _i64(_GOLDEN)
    z = z ^ lsr(z, 30)
    z = z * _i64(_M1)
    z = z ^ lsr(z, 27)
    z = z * _i64(_M2)
    return z ^ lsr(z, 31)


def umod(z: torch.Tensor, m: int) -> torch.Tensor:
    """``z mod m`` of int64 bit patterns read as uint64."""
    top = (z < 0).to(torch.int64)
    return ((z & 0x7FFFFFFFFFFFFFFF) % m + top * ((1 << 63) % m)) % m


@functools.lru_cache(maxsize=None)
def kind(name: str, where: Path = CONTENT) -> Callable[[torch.Tensor, int], None]:
    """``fill`` of content kind ``name``: ``<where>/<name>.py``."""
    path = Path(where) / f"{name}.py"
    if not path.is_file():
        known = sorted(p.stem for p in Path(where).glob("*.py"))
        raise ValueError(f"unknown content kind {name!r}; known: {known}")
    spec = importlib.util.spec_from_file_location(f"benchmark.content.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fill


def content(name: str, n: int, seed: int, device, where: Path = CONTENT) -> bytes:
    """``n`` bytes of content kind ``name`` from ``seed``, made on ``device``."""
    fill = kind(name, Path(where))
    out = torch.empty(n, dtype=torch.uint8, device=device)
    if n:
        fill(out, seed)
    host = out.cpu()
    del out
    return host.numpy().tobytes()


def file_seed(seed: int, j: int) -> int:
    """The content seed of a mix's file ``j``: the run's seed for the first."""
    return seed + 1_000_003 * j


def load_mix(path: Path, where: Path = CONTENT) -> dict:
    """A traffic mix: its files (name, bytes, content) and its order."""
    mix = json.loads(Path(path).read_text())
    for f in mix["files"]:
        if not (Path(where) / f"{f['content']}.py").is_file() or int(f["bytes"]) < 0:
            raise ValueError(f"{path}: bad file entry {f}")
    if mix.get("order", "fixed") not in ("fixed", "shuffle"):
        raise ValueError(f"{path}: order is 'fixed' or 'shuffle'")
    return mix


def make_files(mix: dict, seed: int, device, where: Path = CONTENT) -> list[File]:
    """Every file of ``mix`` from ``seed``, in the mix's listed order."""
    return [File(f["name"], content(f["content"], int(f["bytes"]), file_seed(seed, j), device,
                                    where))
            for j, f in enumerate(mix["files"])]


def file_order(mix: dict, seed: int):
    """File indices in the mix's order, pass after pass: each pass a
    permutation drawn from ``seed`` where the order is ``shuffle``."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 11])
    n = len(mix["files"])
    while True:
        yield from (rng.permutation(n).tolist() if mix.get("order", "fixed") == "shuffle"
                    else range(n))
