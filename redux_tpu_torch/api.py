"""Block-parallel compress/decompress of RXT v2 archives: the entry
points, their call plan and decode's lane staging.

Counterpart: ``redux_tpu/api.py`` — ``encode`` (:226-398) and ``decode``
(:401-576) with their helpers (:51-138).  The same steps, the same bytes:

1. split the input into fixed-size blocks;
2. derive the warm-start prior from the global byte histogram;
3. per block and position, the model values (K1, ``ops.model``);
4. the interval coder over all blocks at once (K2, ``ops.encode``);
5. splice the per-block streams, storing incompressible blocks raw;

and for decode, the lanes sorted by coded length, the decoder (K3,
``ops.decode``), the inverse permutation, the raw splice and the crc.

The data lives on the device between one upload and one fetch
(:mod:`._pipeline`), staged there by ``ops.staging`` (S1 row gather, S2
payload splice, S3 crc32, S4 byte histogram) where the reference staged
it on the host.  ``encode`` reads the input in lane chunks twice
(histogram and crc, then the kernels; an input of one chunk a device
crosses the bus once); ``decode`` works a range of blocks at a time, so
its device memory is two ranges' worth whatever the input's size.  Only
the header, the prior's 256 counts and the lanes' order are host work.
A call made with ``_timings`` is recorded (:mod:`._record`).

The device defaults to the card: ``device="cuda"`` runs the kernels, and
with no CUDA device a call raises RuntimeError before any kernel work
instead of running anything else.  The CPU runs the kernels' plain
PyTorch versions only when the caller asks for it (``device="cpu"``, as
the tests do).  A sequence of two or more devices splits the blocks
over them (the explicit counterpart of the reference's ``_dp_mesh``
branches, :98-113, :300-316, :483-510, which shard every chunk over
every device): a call runs in steps (:func:`_shares`), each giving each
device one contiguous share of at most a lane chunk, and each device
(:class:`_Card`) uploads, codes, splices, checks and fetches its own
shares; only the histogram's 256 counts, the CRCs and the wire lengths
meet on the host.  A list may name one device twice.  The archive bytes
do not depend on the devices.

The routes of ``redux_tpu/api.py:579-720`` follow: ``encode_compact`` /
``decode_compact`` (one v2 block in a compact archive, host code through
:mod:`redux_tpu_torch.native`) and ``encode_auto`` / ``decode_auto`` (the
smallest of the self-decodable candidates, and the decoder that tells
them apart).  Unlike the reference, they never fall back to the Python
oracle when the native library cannot be built: that fallback would
change ``encode_auto``'s candidates, and so its bytes, silently.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import _record, container, native
from ._pipeline import _Fetch, _Output, _to_device, _to_host, _Upload
from ._record import recorded_calls  # noqa: F401  (read from here by the benchmark)
from .container import DEFAULT_BLOCK_SIZE, DEFAULT_DELTA, DEFAULT_PRIOR_BUDGET
from .convert import init_cum_from_numpy
from .errors import InvalidInputError, ReduxError
from .models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from .ops.coder import max_block_words
from .ops.decode import decode_blocks
from .ops.encode import encode_blocks_ranked, fused_selected
from .ops.staging import byte_histogram, combine_crcs, crc32_device, gather_rows, splice_payload
from .params import Parameters

# Default decode lane quantum of the reference (its LANES x PHASES = 1024 x 1):
# the auto block size snaps the block count under a multiple of it.
LANE_QUANTUM = 1024
_AUTO_BS_MIN = 1 << 21  # auto block sizing applies to inputs >= 2 MiB
ENC_CHUNK_BYTES = 256 << 20  # input bytes per encode dispatch
DEC_CHUNK_BYTES = 256 << 20  # decoded bytes per decode dispatch


def _static_words(params: Parameters, k: int, delta: int = DEFAULT_DELTA) -> int:
    max_count = min(params.symbol_count + DEFAULT_PRIOR_BUDGET + delta * k, params.freq_max)
    return max_block_words(max_count, params.symbol_count, params, k)


def _block_lens(n: int, block_size: int) -> np.ndarray:
    """(n_blocks,) int32 symbols a block of an ``n``-byte input."""
    n_blocks = -(-n // block_size)
    return np.minimum(block_size, n - block_size * np.arange(n_blocks, dtype=np.int64)
                      ).astype(np.int32)


def _encode_words(params: Parameters, k: int, delta: int) -> int:
    """Per-block output capacity of the encoder.  Blocks whose stream
    reaches their raw size are stored raw, so the buffer never needs the
    adversarial bound."""
    return min(_static_words(params, k, delta), k // 4 + 16)


def _prior_extra(hist: np.ndarray, params: Parameters,
                 prior_budget: int) -> Optional[np.ndarray]:
    """The warm-start prior (256 extra counts) from the byte histogram, or
    None for an empty input or an all-zero quantization."""
    if not hist.any():
        return None
    extra = quantize_prior(hist, params, min(prior_budget, params.freq_max // 2))[:256]
    return extra if extra.max(initial=0) > 0 else None


def _init_cum(params: Parameters, prior_extra: Optional[np.ndarray]) -> np.ndarray:
    if prior_extra is None:
        return uniform_init_cum(params).astype(np.int32)
    full = np.zeros(params.symbol_count, dtype=np.int64)
    full[:256] = prior_extra
    return prior_init_cum(full, params).astype(np.int32)


def _auto_block_size(n: int, lane_quantum: int = LANE_QUANTUM) -> int:
    """Block size that lands the block count just under a multiple of
    ``lane_quantum``; 256-aligned, at least 1024."""
    blocks0 = -(-n // DEFAULT_BLOCK_SIZE)
    lanes = -(-blocks0 // lane_quantum) * lane_quantum
    k = -(-(-(-n // lanes)) // 256) * 256
    return max(k, 1024)


def _lane_chunk(chunk_bytes: int, block_size: int) -> int:
    """Blocks (lanes) a chunk of ``encode`` or ``decode`` takes:
    ``chunk_bytes`` of blocks, a multiple of 128 and at least 128."""
    return max(128, (chunk_bytes // max(block_size, 1)) // 128 * 128)


def _default_block_size(n: int) -> int:
    """``encode``'s block size for ``n`` bytes: 4 KiB, auto-sized from 2 MiB."""
    return _auto_block_size(n) if n >= _AUTO_BS_MIN else DEFAULT_BLOCK_SIZE


def _check_config(params: Parameters, init_total: int):
    """Reject configs whose adaptation would freeze from the start, or
    whose products no coder fits."""
    fits = params.fits_u32 or params.fits_wide32 or params.code_bits + params.freq_bits <= 62
    if init_total >= params.freq_max or not fits:
        raise InvalidInputError()


Devices = Union[torch.device, str, Sequence[Union[torch.device, str]]]


def _cards(device: Devices) -> list[torch.device]:
    """The devices of a call, one share of a step each (:func:`_shares`):
    ``device`` alone, or each of a sequence, which may name a device more
    than once.  A CUDA device without an index is card 0, the card the
    kernels' launchers take for it, so every tensor of the call names its
    card whatever the current device."""
    devs = [device] if isinstance(device, (torch.device, str)) else list(device)
    if not devs:
        raise ValueError("a device list needs at least one device")
    devs = [torch.device(d) for d in devs]
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
            for d in devs]


def _require_cuda(*devices: torch.device) -> None:
    """Raise for a CUDA device on a machine without one: the card is the
    default, and the CPU runs only when the caller names it."""
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError(
            "redux_tpu_torch: device 'cuda' (the default) but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions")


class _Share(NamedTuple):
    """Blocks ``s0 .. s1`` of a call, on its device ``card`` (an index into
    the call's devices), that device's share number ``i``."""

    card: int
    i: int
    s0: int
    s1: int


def _shares(n_blocks: int, chunk: int, n_cards: int) -> list[list[_Share]]:
    """The steps of a call over ``n_cards`` devices, in block order: each
    step gives each device at most one contiguous share of at most
    ``chunk`` blocks.  A step takes the next ``n_cards * chunk`` blocks, a
    chunk a device; the blocks left after the last such step are split
    evenly over the devices (the first ones take a block more where they
    do not divide), so a device goes without a share only where fewer
    blocks than devices are left.  One device: the lane chunks of
    ``chunk`` blocks, the last one the rest."""
    steps, s0, count = [], 0, [0] * n_cards
    while s0 < n_blocks:
        left = n_blocks - s0
        if left >= n_cards * chunk:
            sizes = [chunk] * n_cards
        else:
            sizes = [left // n_cards + (j < left % n_cards) for j in range(n_cards)]
        step = []
        for j, m in enumerate(sizes):
            if m:
                step.append(_Share(j, count[j], s0, s0 + m))
                count[j] += 1
                s0 += m
        steps.append(step)
    return steps


def _by_card(steps: list[list[_Share]], n_cards: int) -> list[list[_Share]]:
    """Each device's shares, in order."""
    own = [[] for _ in range(n_cards)]
    for step in steps:
        for sh in step:
            own[sh.card].append(sh)
    return own


class _Card:
    """An entry ``j`` of a call's devices that has shares, and what the
    call keeps on its ``device``: its shares ``own``, the most blocks one
    has (``rows``), their upload ``up`` and S3's CRC of each (``crcs``);
    from :func:`_open` on, its ``fetch`` into the result and the initial
    row ``ic``.  ``encode`` keeps its histogram (``hist``), its one
    share's blocks (``kept``) and a step's coded share (``coded``);
    ``decode`` its output rows (``outs``)."""

    def __init__(self, j: int, device: torch.device, own: list[_Share], up: _Upload):
        self.j, self.device, self.own, self.up = j, device, own, up
        self.rows = max(sh.s1 - sh.s0 for sh in own)
        self.crcs = torch.zeros(len(own), dtype=torch.int32, device=device)
        self.fetch = self.ic = self.hist = self.kept = self.coded = self.outs = None


def _plan(devs: list[torch.device], steps: list[list[_Share]], data,
          ranges: Callable[[list[_Share]], list], rec) -> tuple[list[_Card], list[list]]:
    """The call's cards, one an entry of ``devs`` with shares in ``steps``,
    each uploading ``ranges(own)`` of ``data``; and each step's
    ``(card, share)`` pairs."""
    own = _by_card(steps, len(devs))
    rec.plan(own)
    cards = {j: _Card(j, devs[j], mine, _Upload(data, ranges(mine), devs[j], rec))
             for j, mine in enumerate(own) if mine}
    return list(cards.values()), [[(cards[sh.card], sh) for sh in step] for step in steps]


def _each(step: Sequence[tuple[_Card, _Share]], *fns: Callable[[_Card, _Share], None],
          rec) -> None:
    """Run the first of ``fns`` on every share of a step, each serving its
    card, then the second, and so on: every device's kernels are queued
    before the host copies that follow them."""
    for fn in fns:
        for card, sh in step:
            rec.serve(card.j)
            fn(card, sh)


def _open(cards: list[_Card], out: _Output, ic: np.ndarray, k: int, rec) -> None:
    """Each card's fetch into ``out`` (slots of its widest share, two where
    it has more than one share), then the initial row ``ic`` on its device."""
    for card in cards:
        card.fetch = _Fetch(out, card.device, card.rows * k, min(2, len(card.own)))
    rec.mark("alloc")
    for card in rec.serving(cards):
        card.ic = _to_device(ic, card.device)
    rec.mark("launch")


def _drain(cards: list[_Card], rec) -> None:
    """Each card's last fetch into the result; the fetches are done."""
    for card in rec.serving(cards):
        card.fetch.drain()
        card.fetch = None


def _crc_of(cards: list[_Card], plan: list[list], n: int, k: int, rec) -> int:
    """The CRC-32 of a call's ``n`` bytes from each share's CRC (one fetch
    a card, the call's ``sums wait``), combined in block order."""
    got = {card: _to_host(card.crcs).to(torch.int64) & 0xFFFFFFFF for card in rec.serving(cards)}
    rec.mark("sums wait")
    order = [(card, sh) for step in plan for card, sh in step]
    return combine_crcs(torch.tensor([int(got[c][sh.i]) for c, sh in order], dtype=torch.int64),
                        torch.tensor([n - min(sh.s1 * k, n) for _, sh in order], dtype=torch.int64))


def encode(
    data: bytes,
    params: Optional[Parameters] = None,
    block_size: Optional[int] = None,
    delta: int = DEFAULT_DELTA,
    use_prior: Optional[bool] = None,
    prior_budget: int = DEFAULT_PRIOR_BUDGET,
    *,
    fused: Optional[bool] = None,
    device: Devices = "cuda",
    _timings: Optional[dict] = None,
) -> bytes:
    """Compress ``data`` into an RXT v2 block-parallel archive.

    Defaults: :meth:`Parameters.tpu_wide`, adaptation increment 16, a
    128k-count warm-start prior for inputs of 4096 bytes or more, and
    4 KiB blocks, auto-sized for inputs >= 2 MiB (see
    :func:`_auto_block_size`).  ``device`` (default ``"cuda"``) runs the
    kernels; ``device="cpu"`` runs their plain versions; a sequence of
    devices splits the blocks over them (:func:`_shares`).

    ``fused`` picks pass 2's encoder (:func:`ops.encode.fused_selected`):
    True codes every share with K4, the fused model and coder, which holds
    no model-value planes on the device, and raises
    :class:`InvalidInputError` before any device work at parameters K4
    does not take (such as (8,30,32)); False runs K1 -> K2; not given,
    ``REDUX_TPU_ENC_FUSED`` picks at each call, as in the reference, with
    K1 -> K2 at parameters K4 does not take.  The archive's bytes are the
    same on either route.

    Each share's payload comes back straight to its offset in the
    returned ``bytes``; the header is written in front of it at the end.

    With ``_timings`` (a dict) the call is recorded (:func:`recorded_calls`)
    and ``_timings`` receives the host seconds of each phase, ``pass1``
    (each share's upload, histogram and crc, the prior), ``pass2`` (each
    share's upload, K1 -> K2 or K4, the payload splice and its fetch) and
    ``header``, and of each part of a phase (``"pass2 stage"``; over
    several devices ``"pass2 stage@j"`` where the part serves the ``j``-th
    device's share), at each mark: no mark waits for a device.
    """
    devs = _cards(device)
    rec = _record.recorder(_timings, "enc", len(data), devs)
    params = params or Parameters.tpu_wide()
    if block_size is None:
        block_size = _default_block_size(len(data))
    if params.symbol_bits != 8:
        raise InvalidInputError("the RXT container is byte-only (symbol_bits = 8)")
    if use_prior is None:
        use_prior = len(data) >= 4096
    # The parameters' own limits before the device's (the prior's total is
    # checked once pass 1 has counted the bytes).
    _check_config(params, int(uniform_init_cum(params)[-1]))
    try:  # pass 2's encoder, once a call
        fused = fused_selected(params, fused)
    except ValueError as e:
        raise InvalidInputError(str(e)) from None
    _require_cuda(*devs)
    n, k = len(data), block_size
    lens = _block_lens(n, k)
    n_blocks = lens.size
    steps = _shares(n_blocks, _lane_chunk(ENC_CHUNK_BYTES, k), len(devs))

    def span(sh: _Share) -> tuple[int, int, int]:
        """The share's bytes, zero past the input to its blocks' end."""
        return sh.s0 * k, min(sh.s1 * k, n), (sh.s1 - sh.s0) * k

    # Each device reads its shares twice (pass 2 again) where it has more
    # than one, else once: it keeps its one share's blocks for pass 2.
    rec.phase("pass1")
    cards, plan = _plan(devs, steps, data,
                        lambda own: [span(sh) for sh in own] * (1 if len(own) == 1 else 2), rec)
    rec.mark("alloc")
    for card in cards:
        card.hist = torch.zeros(256, dtype=torch.int64, device=card.device)
    rec.mark("launch")

    # Pass 1, a step at a time: each share's histogram and crc on its
    # device, fetched once after the last step.
    def count(card: _Card, sh: _Share) -> None:
        slot = card.up.take()
        a, b, _ = span(sh)
        if use_prior:
            byte_histogram(slot[: b - a], card.hist)
        crc32_device(slot[: b - a], card.crcs[sh.i : sh.i + 1])
        if len(card.own) == 1:
            card.kept = slot
        rec.mark("launch")

    for step in plan:  # the next share's host copy while this step's kernels run
        _each(step, count, lambda card, sh: card.up.prefetch(), rec=rec)
    hist = sum((_to_host(card.hist) for card in rec.serving(cards)),
               torch.zeros(256, dtype=torch.int64))
    crc = _crc_of(cards, plan, n, k, rec)
    prior_extra = _prior_extra(hist.numpy(), params, prior_budget) if use_prior else None
    ic = _init_cum(params, prior_extra)
    _check_config(params, int(ic[-1]))
    rec.mark("prior")

    if n == 0:
        archive = container.build_archive(params, block_size, 0, [], prior_extra, delta, crc)
        rec.phase("header")
        rec.mark("header")
        rec.done(len(archive))
        return archive

    # Pass 2, a step at a time: K1 -> K2 (or K4) on each share's blocks and
    # the raw rule, queued on every device of the step before any wire
    # length is read; then, share by share in block order, the payload
    # spliced on its device and fetched from there to its place after
    # the header, which the wire lengths and raw flags then fill.  A
    # block is stored raw unless its stream is shorter, so the payload
    # takes at most n bytes.
    rec.phase("pass2")
    n_words = _encode_words(params, k, delta)
    ic_np = init_cum_from_numpy(ic, params, "cpu")
    ic_total = int(ic_np[-1])  # K2's total, from the host: no read of the card's row
    head_len = container.header_bytes(n_blocks, prior_extra is not None)
    wire_all = np.empty(n_blocks, dtype=np.int32)
    raw_all = np.empty(n_blocks, dtype=bool)

    def code(card: _Card, sh: _Share) -> None:
        blocks = (card.kept if len(card.own) == 1 else card.up.take()).view(sh.s1 - sh.s0, k)
        lens_t = _to_device(lens[sh.s0 : sh.s1], card.device)
        words, bl, ov = encode_blocks_ranked(blocks, lens_t, card.ic, params, n_words, delta,
                                             ic_total, fused)
        # Stored raw: overflowed blocks and any block not smaller coded.
        raw = ov | (bl >= lens_t)
        card.coded = (blocks, words,
                      torch.stack([torch.where(raw, lens_t, bl), raw.to(torch.int32)]))
        rec.mark("launch")

    def overlap(card: _Card, sh: _Share) -> None:
        card.up.prefetch()  # the next share's host copy while the coder runs
        card.fetch.drain()  # the previous share's payload into place, likewise

    with _Output(head_len + n, rec) as out:
        out.prefault(0, head_len)
        _open(cards, out, ic_np, k, rec)
        off = head_len
        for step in plan:
            _each(step, code, overlap, rec=rec)
            for card, sh in step:  # the wire lengths and flags to the host, S2 by them
                rec.serve(card.j)
                (blocks, words, head), card.coded = card.coded, None
                head = _to_host(head)
                rec.mark("lengths wait")
                wire, raw_h = head[0], head[1].bool()
                wire_all[sh.s0 : sh.s1], raw_all[sh.s0 : sh.s1] = wire.numpy(), raw_h.numpy()
                size = int(wire.numpy().sum(dtype=np.int64))
                out.prefault(off, off + size)
                payload = splice_payload(words, blocks, raw_h, wire)
                rec.mark("launch")
                card.fetch.put(sh.i, payload, off)
                off += size
                del blocks, words, payload
        _drain(cards, rec)
        rec.phase("header")
        out.ready(0, head_len)
        container.write_header(out.view.numpy(), params, block_size, n, prior_extra, delta,
                               crc, raw_all, wire_all)
        rec.mark("header")
        archive = out.result(off)
        rec.mark("header")
        rec.done(len(archive))
        return archive


class _Lanes(NamedTuple):
    """The decoder's lanes of an archive, one a block."""

    raw: np.ndarray  # (B,) bool: stored raw, no symbols to decode
    block_lens: np.ndarray  # (B,) int32 symbols a block
    coded_lens: np.ndarray  # (B,) int64 coded stream bytes, 0 for a raw block


def _by_length(lens: np.ndarray) -> np.ndarray:
    """The stable argsort of stream lengths (numpy's radix sort when they
    fit 16 bits, as they do below 16 KiB blocks)."""
    if lens.size and lens.max() < 1 << 16:
        lens = lens.astype(np.uint16)
    return np.argsort(lens, kind="stable")


def _decode_lanes(table: container.BlockTable) -> _Lanes:
    """Which blocks of ``table`` (:func:`container.parse_table`) are coded
    and their stream lengths (K3 takes a range's coded blocks sorted by
    them, :func:`_by_length`); InvalidInputError where a raw block's stored
    length is not its block length, or a coded stream is longer than the
    decoder's row (``n_words + 2`` words, :func:`_stage_lanes`) can hold:
    the encoder never writes one."""
    block_lens = _block_lens(table.orig_len, max(table.block_size, 1))  # parse checked n_blocks
    raw = table.raw
    if (table.byte_lens[raw] != block_lens[raw]).any():
        raise InvalidInputError()
    coded_lens = np.where(raw, 0, table.byte_lens)
    n_words = _static_words(table.params, table.block_size, table.delta)
    if coded_lens.max(initial=0) > 4 * (n_words + 2):
        raise InvalidInputError()
    return _Lanes(raw, block_lens, coded_lens)


def _stage_lanes(arch: torch.Tensor, header, lanes: _Lanes, sel: np.ndarray, base: int = 0):
    """K3's input for the lanes ``sel`` of the archive bytes ``arch`` (a
    uint8 tensor from archive offset ``base`` on; S1 on its device): their
    streams as a ``(len(sel), wcap)`` word matrix, zero past each stream
    and for two words past the longest (reads past a stream's terminator
    see zero bits; the kernel also bounds-checks its row), and their int32
    symbol counts, 0 for a raw block.  S1 takes the offsets and lengths
    as host arrays: no wait for the card."""
    dev = arch.device
    n_words = _static_words(header.params, header.block_size, header.delta)
    lens_o = lanes.coded_lens[sel]
    wcap = min(max(4, -(-int(lens_o.max(initial=0)) // 4) + 2), n_words + 2)
    words = gather_rows(arch, header.stream_offs[sel] - base, lens_o, wcap, words=True)
    klens = np.where(lanes.raw[sel], 0, lanes.block_lens[sel]).astype(np.int32)
    return words, _to_device(klens, dev)


def _stream_ends(header, lanes: _Lanes) -> np.ndarray:
    """(B,) int64 end of each block's bytes in the archive: its offset and
    its wire length (the payload is in block order, so blocks ``s0 .. s1``
    lie in ``archive[stream_offs[s0] : ends[s1 - 1]]``)."""
    return header.stream_offs + np.where(lanes.raw, lanes.block_lens, lanes.coded_lens)


def _decode_chunk(arch: torch.Tensor, base: int, header, lanes: _Lanes, s0: int,
                  out: torch.Tensor, ic_t: torch.Tensor, rec) -> None:
    """Blocks ``s0 .. s0 + len(out)`` into the rows of ``out`` (``(rows,
    k)`` uint8 on ``arch``'s device) from their slice ``arch`` of the
    archive, which starts at archive offset ``base``: a raw block's row is
    its stored bytes (S1, bytes), the coded blocks go through S1 (words)
    and K3 sorted by coded length, and their symbols into their rows.  Both
    S1 calls check their rows on the host and queue their kernels with no
    wait.  No coded block, no K3.  Recorded (``rec``): the lanes' host work
    with both S1 calls (``lanes``), then K3 and the rows' placement
    (``launch``)."""
    dev = arch.device
    raw = lanes.raw[s0 : s0 + out.shape[0]]
    ri, ci = np.flatnonzero(raw), np.flatnonzero(~raw)
    if ri.size:
        r = s0 + ri
        rows = gather_rows(arch, header.stream_offs[r] - base,
                           lanes.block_lens[r].astype(np.int64), out.shape[1])
    if ci.size:
        ci = ci[_by_length(lanes.coded_lens[s0 + ci])]
        words, klens = _stage_lanes(arch, header, lanes, s0 + ci, base)
    rec.mark("lanes")
    if ci.size:
        k, p, d = header.block_size, header.params, header.delta
        syms = decode_blocks(words, klens, ic_t, p, k, d)
        del words
        out.index_copy_(0, _to_device(ci, dev), syms)
    if ri.size:
        out.index_copy_(0, _to_device(ri, dev), rows)
    rec.mark("launch")


def decode(archive: bytes, *, device: Devices = "cuda",
           _timings: Optional[dict] = None) -> bytes:
    """Decompress an RXT archive.

    Verifies the stored crc32 and raises :class:`InvalidInputError` on any
    corruption instead of returning garbage.  ``device`` (default
    ``"cuda"``) runs the kernel; ``device="cpu"`` runs its plain version; a
    sequence of devices splits the blocks over them (:func:`_shares`); a
    share's rows come back while the next share decodes (:func:`_decode_chunk`).

    With ``_timings`` (a dict) the call is recorded (:func:`recorded_calls`)
    and ``_timings`` receives the host seconds of each phase, summed over
    the shares: ``parse`` (the header and the lanes), ``upload`` (a
    share's slice), ``kernels`` (S1 -> K3 into the rows, the raw rows) and
    ``crc+fetch`` (S3, the copy to the host and into the result, the
    CRCs' combine and check), and of each part of a phase (``"kernels
    lanes"``; over several devices ``"kernels lanes@j"`` where the part
    serves the ``j``-th device's share), at each mark: no mark waits for a
    device, so a recorded call overlaps what an unrecorded one does.
    """
    devs = _cards(device)
    rec = _record.recorder(_timings, "dec", len(archive), devs)
    rec.phase("parse")
    header = container.parse_table(archive)
    params = header.params
    _require_cuda(*devs)
    if header.orig_len == 0:
        container.verify_crc(header, b"")
        rec.mark("parse")
        rec.done(0)
        return b""
    n, k, n_blocks = header.orig_len, header.block_size, header.n_blocks
    lanes = _decode_lanes(header)
    ic = init_cum_from_numpy(_init_cum(params, header.prior_extra), params, "cpu")
    steps = _shares(n_blocks, _lane_chunk(DEC_CHUNK_BYTES, k), len(devs))
    ends = _stream_ends(header, lanes)
    base = {sh: int(header.stream_offs[sh.s0]) for step in steps for sh in step}
    rec.mark("parse")
    cards, plan = _plan(devs, steps, archive, lambda own: [
        (base[sh], int(ends[sh.s1 - 1]), int(ends[sh.s1 - 1]) - base[sh]) for sh in own], rec)
    for card in cards:
        card.outs = torch.empty(min(2, len(card.own)), card.rows, k, dtype=torch.uint8,
                                device=card.device)

    def rows_of(card: _Card, sh: _Share) -> torch.Tensor:
        return card.outs[sh.i % card.outs.shape[0], : sh.s1 - sh.s0]

    def decode_share(card: _Card, sh: _Share) -> None:
        rec.phase("upload")
        arch = card.up.take()
        rec.mark("launch")
        rec.phase("kernels")
        _decode_chunk(arch, base[sh], header, lanes, sh.s0, rows_of(card, sh), card.ic, rec)

    def fetch_share(card: _Card, sh: _Share) -> None:
        rec.phase("upload")
        card.up.prefetch()  # the next share's host copy while K3 runs
        rec.phase("crc+fetch")
        card.fetch.drain()  # the previous share into the result, likewise
        flat = rows_of(card, sh).view(-1)[: min(sh.s1 * k, n) - sh.s0 * k]
        crc32_device(flat, card.crcs[sh.i : sh.i + 1])
        rec.mark("launch")
        card.fetch.put(sh.i, flat, sh.s0 * k)

    with _Output(n, rec) as output:
        for step in steps:  # every byte of the result is written, a share at a time
            for sh in step:
                output.prefault(sh.s0 * k, min(sh.s1 * k, n))
        _open(cards, output, ic, k, rec)
        for step in plan:
            _each(step, decode_share, fetch_share, rec=rec)
        _drain(cards, rec)
        ok = _crc_of(cards, plan, n, k, rec) == header.crc32
        rec.mark("check")
        if not ok:
            raise InvalidInputError()
        result = output.result(n)
        rec.mark("check")
        rec.done(n)
        return result

def encode_compact(data: bytes, cfg: int) -> bytes:
    """Compress into an RXT compact archive: one v2 block under a 5-7 byte
    header, for inputs where the block archive's header would erase the
    win.  ``cfg`` indexes ``container.COMPACT_CONFIGS``.  Host code (the
    native serial coder); raises ``native.NativeUnavailable`` if the
    library cannot be built."""
    params, delta = container.compact_config(cfg)
    payload = native.compress_block_v2(data, params, None, delta)
    return container.build_compact(cfg, len(data), payload, container.compute_crc(data))


def decode_compact(archive: bytes) -> bytes:
    """Decode an RXT compact archive; InvalidInputError on corruption.
    Host code, as :func:`encode_compact`."""
    params, delta, orig_len, crc16, payload = container.parse_compact(archive)
    out = native.decompress_block_v2(payload, orig_len, params, None, delta)
    container.verify_crc16(crc16, out)
    return out


# Compact candidates of encode_auto: delta 2 suits high-entropy and binary
# inputs, 16 suits text.  Indices into container.COMPACT_CONFIGS.
_COMPACT_AUTO_CFGS = (0, 2, 4)  # delta 2, 8, 16
_COMPACT_MAX = 1 << 20  # the serial single-block encode pays below ~1 MiB


def encode_auto(
    data: bytes,
    params: Optional[Parameters] = None,
    block_size: Optional[int] = None,
    *,
    device: Devices = "cuda",
) -> bytes:
    """Compress to the smallest of the self-decodable candidates:

    1. the block archive with the warm-start prior;
    2. from 4096 bytes, the block archive with uniform init;
    3. above ``_COMPACT_MAX`` with blocks under 16 KiB, the block archive
       with 16 KiB blocks;
    4. up to ``_COMPACT_MAX``, compact archives at ``_COMPACT_AUTO_CFGS``
       and, when ``params`` is None, the bare reference-format stream
       (unless its first bytes would misroute in :func:`decode_auto`).

    :func:`decode_auto` tells every candidate apart.  ``device`` runs the
    block encodes, as in :func:`encode`; the compact candidates and the
    bare stream are host code through :mod:`redux_tpu_torch.native`,
    which raises if it cannot be built (no fallback to the oracle).
    """
    candidates = [encode(data, params=params, block_size=block_size, use_prior=True,
                         device=device)]
    if len(data) >= 4096:  # the reference's threshold for the uniform candidate
        candidates.append(
            encode(data, params=params, block_size=block_size, use_prior=False, device=device)
        )
    if len(data) > _COMPACT_MAX and (block_size or DEFAULT_BLOCK_SIZE) < (1 << 14):
        candidates.append(
            encode(data, params=params, block_size=1 << 14, use_prior=True, device=device)
        )
    if 0 < len(data) <= _COMPACT_MAX:
        for cfg in _COMPACT_AUTO_CFGS:
            candidates.append(encode_compact(data, cfg))
        if params is None:
            ref = native.compress_bytes(data, Parameters.default())
            # A stream starting with the block archive's magic would
            # misroute in decode_auto, and one starting with the compact
            # magic could pass a compact parse and crc16 by chance.
            if not container.is_rxt_archive(ref) and not (
                len(ref) and ref[0] == container.COMPACT_MAGIC
            ):
                candidates.append(ref)
    return min(candidates, key=len)


def decode_auto(data: bytes, params: Optional[Parameters] = None, *,
                device: Devices = "cuda") -> bytes:
    """Decode a block archive, a compact archive or a bare reference-format
    stream.

    Reference streams carry no magic, so what is neither archive (or a
    compact-looking stream that fails its parse or crc16) is decoded as a
    bare stream at ``params`` (default: the reference CLI's (8,30,32)).
    ``device`` runs the block archive's decode, as in :func:`decode`; the
    rest is host code through :mod:`redux_tpu_torch.native`.
    """
    if container.is_rxt_archive(data):
        return decode(data, device=device)
    if container.is_compact_archive(data):
        try:
            return decode_compact(data)
        except ReduxError:
            pass
    return native.decompress_bytes(data, params)
