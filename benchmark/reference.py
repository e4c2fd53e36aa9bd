"""The plain reference of an RXT v2 archive, in numpy and torch, and the comparison
that decides a run's ``correct``.

It imports nothing of the program under test: the archive layout, the
warm-start prior, the block layout and the block coder are written out
here from the format (the upstream codec's Witten-Neal-Cleary coder,
``src/codec.rs``, with its v2 block termination) and worked out from the
input alone.  The coder runs a batch of blocks side by side, one step of
torch operations a symbol position, on the CPU or a card: the interval split of every block, the
renormalisation in closed form (the E1/E2 bits are the leading bits
``low`` and ``high`` share, the E3 count the run of ``01`` / ``10``
below them), and the bits packed into 32-bit words.

:func:`compare_files` holds round trips to it: the header (parameters,
sizes, prior, CRC), the block table, each sampled block's stream, every
raw block's bytes, and the decoded bytes against the input.  Each number
is a count of things that differ; every limit is 0.  :func:`archives`
writes whole archives from the reference, which with its quotient one
precision low is the check's control (:mod:`benchmark.control`).
"""

from __future__ import annotations

import itertools
import struct
import warnings
import zlib
from typing import Callable, Optional

import numpy as np
import torch

MAGIC = b"RXT1"
HEADER_BYTES = 32
RAW_BIT = 1 << 31
DEFAULT_BLOCK_SIZE = 4096
AUTO_MIN_BYTES = 1 << 21
LANE_QUANTUM = 1024


class Config:
    """A configuration file's codec settings: parameters ``(symbol, freq,
    code)`` bits, the adaptation increment, the prior's budget, and the
    rules that pick the block size and the prior from the input's size.

    The file's optional ``encode`` object holds keyword settings of the
    program's ``api.encode`` that define the deployment; the harness
    passes them to every encode call.  Two of them change an archive's
    bytes, and the reference follows the program's rule for each:
    ``block_size``, one size for every input, with no auto-sizing; and
    ``use_prior``, a prior always (true) or never (false), where absent
    means from ``prior_min_bytes`` up.  Every other key selects a route
    that leaves the archive's bytes as they are (a fused encoder writes
    the same bytes as the model and the coder apart): the reference
    ignores it, and the byte-for-byte ``header``, ``table`` and ``streams``
    counts of :func:`compare_files` hold the route to that.
    """

    def __init__(self, cfg: dict):
        self.s, self.f, self.c = (int(cfg[k]) for k in ("symbol_bits", "freq_bits", "code_bits"))
        if self.s != 8 or self.f < self.s + 2 or self.c < self.f + 2 or self.c + self.f > 62:
            raise ValueError(f"unsupported parameters ({self.s}, {self.f}, {self.c})")
        self.delta = int(cfg["delta"])
        self.prior_budget = int(cfg["prior_budget"])
        self.prior_min_bytes = int(cfg["prior_min_bytes"])
        settings = cfg.get("encode", {})
        self.fixed_block_size = settings.get("block_size")
        self.use_prior = settings.get("use_prior")
        if self.fixed_block_size is not None and (type(self.fixed_block_size) is not int
                                                  or self.fixed_block_size < 1):
            raise ValueError(f"encode block_size {self.fixed_block_size!r} is not a positive int")
        if self.use_prior is not None and not isinstance(self.use_prior, bool):
            raise ValueError(f"encode use_prior {self.use_prior!r} is not true or false")
        self.n_symbols = (1 << self.s) + 1
        self.freq_max = (1 << self.f) - 1
        self.quarter = 1 << (self.c - 2)
        self.half = 2 * self.quarter
        self.code_max = (1 << self.c) - 1

    def block_size(self, n: int) -> int:
        """The configuration's ``block_size``; else 4 KiB, or for inputs of
        2 MiB and more the size that lands the block count just under a
        multiple of 1024 lanes (256-aligned, at least 1024)."""
        if self.fixed_block_size is not None:
            return self.fixed_block_size
        if n < AUTO_MIN_BYTES:
            return DEFAULT_BLOCK_SIZE
        lanes = -(-(-(-n // DEFAULT_BLOCK_SIZE)) // LANE_QUANTUM) * LANE_QUANTUM
        return max(-(-(-(-n // lanes)) // 256) * 256, 1024)

    def has_prior(self, n: int) -> bool:
        """Whether an archive of ``n`` bytes carries a prior (where its
        counts are not all 0): the configuration's ``use_prior``, else
        from ``prior_min_bytes`` up."""
        return n >= self.prior_min_bytes if self.use_prior is None else self.use_prior


def block_lens(n: int, k: int) -> np.ndarray:
    nb = -(-n // k)
    return np.minimum(k, n - k * np.arange(nb, dtype=np.int64))


def histogram(data: bytes) -> np.ndarray:
    if not data:
        return np.zeros(256, dtype=np.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only buffer, only read
        u8 = torch.frombuffer(data, dtype=torch.uint8)
    return torch.bincount(u8, minlength=256).numpy().astype(np.int64)


def prior_extra(hist: np.ndarray, cfg: Config) -> Optional[np.ndarray]:
    """The 256 warm-start counts: the largest-remainder apportionment of
    ``budget - symbols`` counts over the histogram (budget at most half
    of ``freq_max``), each clamped to u16; None when all are 0."""
    total = int(hist.sum())
    head = max(0, min(cfg.prior_budget, cfg.freq_max // 2) - cfg.n_symbols)
    if total <= 0 or head <= 0:
        return None
    ideal = hist.astype(np.float64) * head / total
    fl = np.floor(ideal).astype(np.int64)
    short = head - int(fl.sum())
    if short > 0:
        fl[np.argsort(-(ideal - fl), kind="stable")[:short]] += 1
    extra = np.minimum(fl, 0xFFFF)
    return extra if extra.max() > 0 else None


def init_cum(cfg: Config, extra: Optional[np.ndarray]) -> np.ndarray:
    """The row every block's model starts from: ``cum[i]`` counts below
    symbol ``i`` (257 symbols, the last the unused EOF)."""
    counts = np.ones(cfg.n_symbols, dtype=np.int64)
    if extra is not None:
        counts[:256] += extra
    return np.concatenate([[0], np.cumsum(counts)])


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 below 2**53."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64)


def _mask(n: torch.Tensor) -> torch.Tensor:
    """``2**n - 1`` of each ``n`` in 0..32."""
    return torch.bitwise_left_shift(torch.ones_like(n), n) - 1


def exact_quotient(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.div(num, den, rounding_mode="floor")


def float_quotient(dtype: torch.dtype) -> Callable:
    """The interval split's quotient rounded through ``dtype``: a control's
    precision, below the exact integer arithmetic a configuration states."""
    def quotient(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
        return torch.floor(num.to(dtype) / den.to(dtype)).to(torch.int64)
    return quotient


class _Bits:
    """MSB-first bit strings of a batch of lanes, packed into 32-bit words
    (int64 bit patterns: a lane holds fewer than 32 bits between puts)."""

    def __init__(self, lanes: int, words: int, device: torch.device):
        self.out = torch.zeros((lanes, words), dtype=torch.int64, device=device)
        self.acc = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.nacc = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.wpos = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.rows = torch.arange(lanes, device=device)

    def put(self, value: torch.Tensor, nbits: torch.Tensor) -> None:
        """Append the low ``nbits`` (0-32, a lane) of ``value`` to each lane."""
        self.acc = torch.bitwise_left_shift(self.acc, nbits) | (value & _mask(nbits))
        self.nacc = self.nacc + nbits
        full = (self.nacc >= 32).to(torch.int64)
        shift = (self.nacc - 32) * full
        # A lane past its row (only a coder that is wrong gets there) keeps
        # writing its last word; its stream is cut at the row's end.
        last = self.out.shape[1] - 1
        word = torch.bitwise_right_shift(self.acc, shift) & 0xFFFFFFFF
        self.out[self.rows, self.wpos.clamp(max=last)] = word
        self.wpos = self.wpos + full
        self.nacc = self.nacc - 32 * full
        self.acc = self.acc & _mask(self.nacc)

    def put_run(self, bit: torch.Tensor, run: torch.Tensor, on: torch.Tensor) -> None:
        """Append, to the lanes where ``on`` holds, ``bit`` and then ``run``
        copies of its opposite."""
        run = torch.where(on, run, 0)
        first = run.clamp(max=31)
        self.put(torch.bitwise_left_shift(bit, first) | torch.where(bit == 1, 0, _mask(first)),
                 torch.where(on, 1 + first, 0))
        rest = run - first
        while bool((rest > 0).any()):
            m = rest.clamp(max=32)
            self.put(torch.where(bit == 1, 0, _mask(m)), m)
            rest = rest - m

    def streams(self) -> list[bytes]:
        """Each lane's bits, zero-padded to a whole byte."""
        last = self.out.shape[1] - 1
        self.out[self.rows, self.wpos.clamp(max=last)] = (
            torch.bitwise_left_shift(self.acc, 32 - self.nacc) & 0xFFFFFFFF)
        w = self.out.shape[1] * 4
        nbytes = ((self.wpos * 32 + self.nacc + 7) // 8).clamp(max=w).tolist()
        raw = self.out.cpu().numpy().astype(">u4").tobytes()
        return [raw[i * w : i * w + n] for i, n in enumerate(nbytes)]


def encode_blocks(blocks: np.ndarray, lens: np.ndarray, cum0: np.ndarray, cfg: Config,
                  quotient: Callable = exact_quotient, device="cpu") -> list[bytes]:
    """The v2 stream of each block (a row of ``blocks``, ``lens[i]``
    symbols long) under the adaptive model that starts from ``cum0``
    (one row for every block, or a row a block), computed on ``device``.
    ``quotient(num, den)`` computes the interval split's
    ``range * bound // total``."""
    dev = torch.device(device)
    S, K = blocks.shape
    if S == 0:
        return []
    c = cfg.c
    blocks = torch.from_numpy(np.ascontiguousarray(blocks)).to(dev)
    lens = torch.as_tensor(np.asarray(lens, dtype=np.int64)).to(dev)
    cum0 = torch.as_tensor(np.asarray(cum0, dtype=np.int64)).to(dev).expand(S, cfg.n_symbols + 1)
    # The model's counts: each symbol's adaptations (a row of 17 groups of
    # 16) and each group's sum; cum[s] = cum0[s] + delta * (the groups'
    # sums below s's group + the counts below s in its group).
    fine = torch.zeros((S, 17, 16), dtype=torch.int64, device=dev)
    coarse = torch.zeros((S, 17), dtype=torch.int64, device=dev)
    grown = torch.zeros(S, dtype=torch.int64, device=dev)
    ar16, ar17 = torch.arange(16, device=dev), torch.arange(17, device=dev)
    rows = torch.arange(S, device=dev)
    low = torch.zeros(S, dtype=torch.int64, device=dev)
    high = torch.full((S,), cfg.code_max, dtype=torch.int64, device=dev)
    pending = torch.zeros(S, dtype=torch.int64, device=dev)
    bits = _Bits(S, K * (cfg.f + 2) // 32 + 8, dev)
    mask, lower = cfg.code_max, cfg.half - 1
    for t in range(int(lens.max())):
        act = t < lens
        sym = blocks[:, t].to(torch.int64)
        g, r = sym >> 4, sym & 15
        row = fine[rows, g]
        below = (coarse * (ar17 < g[:, None])).sum(1) + (row * (ar16 < r[:, None])).sum(1)
        total = cum0[:, -1] + cfg.delta * grown
        lo_f = cum0[rows, sym] + cfg.delta * below
        hi_f = cum0[rows, sym + 1] + cfg.delta * (below + row[rows, r])
        grow = (act & (total < cfg.freq_max)).to(torch.int64)
        fine[rows, g, r] += grow
        coarse[rows, g] += grow
        grown += grow
        rng = high - low + 1
        high = torch.where(act, low + quotient(rng * hi_f, total) - 1, high)
        low = torch.where(act, low + quotient(rng * lo_f, total), low)
        # E1/E2: the leading bits low and high share go out, the first
        # followed by the pending E3 bits.
        k = torch.where(act, c - _bit_length((low ^ high) & mask), 0)
        out = k > 0
        bits.put_run((low >> (c - 1)) & 1, pending, out)
        rest = (k - 1).clamp(min=0)
        bits.put((low >> (c - k).clamp(min=0)) & _mask(rest), rest)
        pending = torch.where(out, 0, pending)
        low = torch.bitwise_left_shift(low, k) & mask
        high = (torch.bitwise_left_shift(high, k) | _mask(k)) & mask
        # E3: the run of low's 1 bits and high's 0 bits below the top.
        ones = (c - 1) - _bit_length(lower & ~low)
        zeros = (c - 1) - _bit_length(high & lower)
        m = torch.where(act, torch.minimum(ones, zeros), 0)
        pending = pending + m
        low = torch.bitwise_left_shift(low, m) & lower
        high = (torch.bitwise_left_shift(high, m) & lower) | cfg.half | _mask(m)
    # The terminator tq = ceil(low / quarter) in {0, 1, 2}: two bits, the
    # pending bits after the first.
    tq = (low + cfg.quarter - 1) // cfg.quarter
    every = torch.ones(S, dtype=torch.bool, device=dev)
    bits.put_run(tq >> 1, pending, every)
    bits.put(tq & 1, every.to(torch.int64))
    return bits.streams()


def _header_fields(archive: bytes) -> Optional[dict]:
    """The fixed fields of an archive's header, or None if it is too short."""
    if len(archive) < HEADER_BYTES:
        return None
    version, flags, s, f, c, delta, reserved = struct.unpack_from("<BBBBBBH", archive, 4)
    block_size, orig_len, n_blocks, crc = struct.unpack_from("<IQII", archive, 12)
    return dict(magic=archive[:4], version=version, flags=flags, symbol_bits=s, freq_bits=f,
                code_bits=c, delta=delta, reserved=reserved, block_size=block_size,
                orig_len=orig_len, n_blocks=n_blocks, crc32=crc)


def expected(data: bytes, cfg: Config) -> dict:
    """What an archive of ``data`` holds before its block table's entries:
    the header's fields, the prior, and the blocks' lengths and first row."""
    n = len(data)
    k = cfg.block_size(n)
    extra = prior_extra(histogram(data), cfg) if cfg.has_prior(n) else None
    lens = block_lens(n, k)
    fields = dict(magic=MAGIC, version=2, flags=int(extra is not None), symbol_bits=cfg.s,
                  freq_bits=cfg.f, code_bits=cfg.c, delta=cfg.delta, reserved=0, block_size=k,
                  orig_len=n, n_blocks=lens.size, crc32=zlib.crc32(data) & 0xFFFFFFFF)
    return dict(fields=fields, extra=extra, k=k, lens=lens, cum0=init_cum(cfg, extra))


def archives(datas: list[bytes], cfg: Config, quotient: Callable = exact_quotient,
             device="cpu", batch: int = 1 << 14) -> list[bytes]:
    """The RXT v2 archive of each of ``datas`` made by the reference:
    header, block table, prior and payload, each block coded and stored
    raw where its stream is no shorter.  The blocks of every input are
    coded together, ``batch`` at a time on ``device``."""
    wants = [expected(data, cfg) for data in datas]
    todo = [(j, i) for j, w in enumerate(wants) for i in range(w["lens"].size)]
    tables = [np.zeros(w["lens"].size, dtype="<u4") for w in wants]
    payloads = [[None] * w["lens"].size for w in wants]
    for a in range(0, len(todo), batch):
        part = todo[a : a + batch]
        width = max(wants[j]["k"] for j, _ in part)
        rows, lens, cums = [], [], []
        for j, group in itertools.groupby(part, key=lambda t: t[0]):
            idx = np.array([i for _, i in group])
            blocks, bl = _rows(datas[j], idx, wants[j]["k"])
            rows.append(np.pad(blocks, ((0, 0), (0, width - wants[j]["k"]))))
            lens.append(bl)
            cums.append(np.broadcast_to(wants[j]["cum0"], (idx.size, wants[j]["cum0"].size)))
        streams = encode_blocks(np.concatenate(rows), np.concatenate(lens), np.concatenate(cums),
                                cfg, quotient, device)
        for (j, i), s, bl in zip(part, streams, np.concatenate(lens).tolist()):
            raw = len(s) >= bl
            k = wants[j]["k"]
            tables[j][i] = (RAW_BIT | bl) if raw else len(s)
            payloads[j][i] = datas[j][i * k : i * k + bl] if raw else s
    out = []
    for w, table, payload in zip(wants, tables, payloads):
        f = w["fields"]
        head = MAGIC + struct.pack("<BBBBBBHIQII", *(f[key] for key in list(f)[1:]))
        prior = w["extra"].astype("<u2").tobytes() if w["extra"] is not None else b""
        out.append(b"".join([head, table.tobytes(), prior, *payload]))
    return out


def _rows(data: bytes, idx: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Blocks ``idx`` of ``data`` as a ``(len(idx), k)`` uint8 matrix, zero
    past each block's end, and their lengths."""
    a = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros((idx.size, k), dtype=np.uint8)
    lens = np.zeros(idx.size, dtype=np.int64)
    for j, i in enumerate(idx.tolist()):
        row = a[i * k : (i + 1) * k]
        out[j, : row.size] = row
        lens[j] = row.size
    return out, lens


NUMBERS = ("header", "table", "streams", "raw", "decoded", "repeats")


def compare_files(items: list[tuple], cfg: Config, rng: np.random.Generator, sample: int,
                  device="cpu") -> dict:
    """Hold each file's round trips (``(data, archives, outputs)``: one
    archive and one decoded output a sampled call) to the reference; each
    number a count of what differs (:data:`NUMBERS`), summed over the
    files:

    ``header``   fields of a file's first archive's header and prior that
                 differ;
    ``table``    block-table entries that differ among the blocks coded by
                 the reference, raw entries whose length is not their
                 block's, and 1 a file whose payload's size is not its
                 table's;
    ``streams``  coded blocks whose stream differs from the reference's,
                 among every block of a file where it has at most
                 ``sample``, else ``sample`` drawn from ``rng`` with the
                 longest stream and the last block;
    ``raw``      blocks stored raw whose bytes are not the input's;
    ``decoded``  outputs that are not their input;
    ``repeats``  archives after a file's first that differ from it.

    The sampled blocks of every file are coded in one batch on ``device``.
    """
    got = dict.fromkeys(NUMBERS, 0)
    todo = []  # (data, archive, k, offsets, stored, raw, sampled blocks, first row)
    for data, archives, outputs in items:
        got["decoded"] += sum(out != data for out in outputs)
        got["repeats"] += sum(a != archives[0] for a in archives[1:])
        if not archives:
            continue
        arch, want = archives[0], expected(data, cfg)
        fields = _header_fields(arch)
        if fields is None:
            got["header"] += len(want["fields"]) + 1
            continue
        got["header"] += sum(fields[key] != v for key, v in want["fields"].items())
        nb, k, lens = want["fields"]["n_blocks"], want["k"], want["lens"]
        head = HEADER_BYTES + 4 * nb + (512 if want["extra"] is not None else 0)
        if len(arch) < head:
            got["header"] += 1
            continue
        if want["extra"] is not None:
            prior = np.frombuffer(arch, dtype="<u2", count=256, offset=HEADER_BYTES + 4 * nb)
            got["header"] += int(not np.array_equal(prior, want["extra"]))
        packed = np.frombuffer(arch, dtype="<u4", count=nb, offset=HEADER_BYTES).astype(np.int64)
        stored, raw = packed & (RAW_BIT - 1), packed >= RAW_BIT
        offs = head + np.cumsum(stored) - stored
        got["table"] += int((stored[raw] != lens[raw]).sum())
        got["table"] += int(head + stored.sum() != len(arch))
        for i in np.flatnonzero(raw).tolist():
            got["raw"] += arch[offs[i] : offs[i] + stored[i]] != data[i * k : i * k + int(lens[i])]
        if nb <= sample:
            idx = np.arange(nb)
        else:
            idx = np.union1d(rng.choice(nb, size=sample, replace=False),
                             [int(np.argmax(np.where(raw, 0, stored))), nb - 1])
        todo.append((data, arch, k, offs, stored, raw, idx, want["cum0"]))
    if not todo:
        return got
    # One batch: every file's sampled blocks, each row padded to the widest block.
    width = max(t[2] for t in todo)
    rows, lens, cums = [], [], []
    for data, _, k, _, _, _, idx, cum0 in todo:
        blocks, blens = _rows(data, idx, k)
        rows.append(np.pad(blocks, ((0, 0), (0, width - k))))
        lens.append(blens)
        cums.append(np.broadcast_to(cum0, (idx.size, cum0.size)))
    streams = iter(encode_blocks(np.concatenate(rows), np.concatenate(lens), np.concatenate(cums),
                                 cfg, device=device))
    for (data, arch, k, offs, stored, raw, idx, _), blens in zip(todo, lens):
        for i, bl in zip(idx.tolist(), blens.tolist()):
            s = next(streams)
            ref_raw = len(s) >= bl
            got["table"] += (bool(raw[i]), int(stored[i])) != (ref_raw, bl if ref_raw else len(s))
            if not ref_raw:
                got["streams"] += arch[offs[i] : offs[i] + stored[i]] != s
    return got
