"""Randomized differential campaign: the port's kernels against their
plain versions and the reference's semantics, on random inputs.

    python -m redux_tpu_torch.fuzz [--seed S] [--trials N] [--minutes M]
                                   [--device cuda|cpu] [--trial T]

Counterpart: ``scripts/fuzz_campaign.py`` (the Pallas kernels against the
oracle).  Trial ``t`` of campaign seed ``s`` draws everything from
``numpy.random.default_rng([s, t])`` (:func:`draw`), so ``--seed s
--trial t`` runs that trial again.  A trial draws a config class and an
(8, f, c) config of it (:data:`CONFIGS`), a delta in 1..255, a block size
(:data:`BLOCK_SIZES`), 1-300 blocks of seven kinds of content, and the
uniform row or a prior quantized from its own histogram.  On the trial's
device it then holds:

1. K1-K5 against their plain versions, K4 and K5 against K2 (both must
   raise ValueError off ``fits_u32 or fits_wide32``), and K3 on every
   complete K2 stream (no ``ovf``, within the word buffer; those not
   smaller than raw too), lanes in block order and sorted
   (:func:`redux_tpu_torch.cuda_checks.compare_kernels`);
2. K2's complete streams against the native serial coder's
   (``native.compress_block_v2``), and K3's symbols against the blocks;
3. on every 4th trial, ``api.encode`` -> ``api.decode`` of the
   concatenated blocks, the archive against ``api.encode(...,
   device="cpu")``; on every 8th, with the lane chunks lowered to
   :data:`CHUNK_BLOCKS` blocks, so that the route runs several of them;
4. on every 4th trial (offset 2), the generic dense-model coders
   (``ops.generic``) against K1 + the reference-format coder, and their
   round trip, on at most :data:`GENERIC_BLOCKS` x :data:`GENERIC_K`.

A block whose stream the reference's own serial coder does not decode
back (the empty interval of ``ROADMAP.md`` Queue 3) is a
``reference_fault``.  It counts neither as a pass nor as a mismatch, and
no comparison of the kernels with their plain versions is loosened for
it.  Past an empty interval the reference's serial coder and its block
kernels may write different bits; the plain versions follow the block
kernels (``tests/test_torch_fuzz.py`` holds them to the JAX package's
block path on the faults the campaign found), so on such a block the
campaign reports whether the port's stream also equals the serial
coder's, and holds K3 to the serial decoder where it does.  Any other difference raises
:class:`Mismatch`; :func:`run_campaign` saves the trial's inputs under
``build/fuzz/`` first, and ``main`` exits 1.  Nothing falls back to a
plain version or to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import api, launch_counts, native, oracle
from ._build import BUILD_DIR
from ._pipeline import _host_u8
from .cuda_checks import KernelInputs, _byte_histogram, compare_kernels
from .errors import ReduxError
from .models.dense import DenseModel
from .ops import coder
from .ops.bitpack import words_to_streams
from .ops.coder import products_fit_53, tfreeze, words_to_bytes
from .ops.generic import decode_blocks_generic, dense_torch_model, encode_blocks_generic
from .ops.model import precompute_encode_model
from .params import Parameters
from .testdata import incompressible

CLASSES = ("u32", "wide32", "fits53", "u64")
CONFIGS = {
    # fits_u32: K1-K5 on 32-bit products.
    "u32": ((8, 10, 12), (8, 12, 14), (8, 14, 16), (8, 12, 18)),
    # fits_wide32 only; (8,21,23) is its edge (code_bits 23, code + freq 44).
    "wide32": ((8, 16, 18), (8, 20, 22), (8, 18, 22), (8, 21, 23)),
    # Neither, but products_fit_53: K2 on reciprocal quotients, K4
    # and K5 refuse; (8,20,32) is the last config with code_bits 32.
    "fits53": ((8, 22, 24), (8, 20, 32)),
    # u64 divisions in K2, from (8,21,32), the first past the edge (K3 takes
    # reciprocal quotients in every class).
    "u64": ((8, 21, 32), (8, 24, 32), (8, 26, 28), (8, 28, 30), (8, 30, 32)),
}
BLOCK_SIZES = (48, 96, 160, 224, 288, 352, 1000, 1022, 4096)
MAX_BLOCKS = 300  # past K3's 32-lane and K5's 128-block CTAs
CHUNK_BLOCKS = 128  # api's least lane chunk
MULTI_CHUNK_MIN_BLOCKS = 200  # the blocks a multi-chunk trial draws at least
GENERIC_BLOCKS, GENERIC_K = 4, 128  # the generic coders take ~3.6 ms a position on the card
FAIL_DIR = BUILD_DIR.parent / "fuzz"


def config_class(params: Parameters) -> str:
    """Which instantiation the encoders take for ``params``: one of :data:`CLASSES`."""
    if params.fits_u32:
        return "u32"
    if params.fits_wide32:
        return "wide32"
    return "fits53" if products_fit_53(params) else "u64"


@dataclasses.dataclass
class Trial:
    """One trial's inputs: ``prior_budget`` None is the uniform row, else
    the row of the prior that ``api`` quantizes from the concatenated
    blocks with that budget (``prior_extra``, None when it is all zero)."""

    seed: int
    index: int
    params: Parameters
    delta: int
    k: int
    blocks: list
    prior_budget: Optional[int] = None
    prior_extra: Optional[np.ndarray] = None

    @property
    def init_cum(self) -> np.ndarray:
        return api._init_cum(self.params, self.prior_extra)

    @property
    def cfg(self) -> tuple:
        p = self.params
        return (p.symbol_bits, p.freq_bits, p.code_bits)

    def arrays(self):
        """``(B, k)`` uint8 blocks, zero past each length, and ``(B,)`` int32 lengths."""
        syms = np.zeros((len(self.blocks), self.k), dtype=np.uint8)
        for i, b in enumerate(self.blocks):
            syms[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        return syms, np.array([len(b) for b in self.blocks], dtype=np.int32)

    def describe(self) -> str:
        return (f"seed={self.seed} trial={self.index} params={self.cfg} delta={self.delta} "
                f"k={self.k} B={len(self.blocks)} prior_budget={self.prior_budget}")


class Mismatch(AssertionError):
    """A difference between the port and its plain versions or the reference."""

    def __init__(self, trial: Trial, detail: str):
        super().__init__(f"{trial.describe()}: {detail}")
        self.trial = trial


def _block(rng: np.random.Generator, k: int) -> bytes:
    """One block: the six kinds of ``scripts/fuzz_campaign.py`` (most full,
    a third of them shorter) or a whole incompressible block."""
    kind = int(rng.integers(0, 7))
    n = int(rng.integers(1, k + 1)) if rng.integers(0, 3) == 0 else k
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return bytes([int(rng.integers(0, 256))] * n)
    if kind == 2:
        return rng.integers(0, int(rng.integers(2, 17)), n, dtype=np.uint8).tobytes()
    if kind == 3:
        return (b"the quick brown fox 0123456789 " * (n // 8 + 1))[:n]
    if kind == 4:  # boundary-heavy: symbols near multiples of 8
        return ((np.arange(n) * 8 + rng.integers(-1, 2, n)) % 256).astype(np.uint8).tobytes()
    if kind == 5:
        return rng.integers(248, 256, n, dtype=np.uint8).tobytes()
    return incompressible(k, int(rng.integers(0, 1 << 31)))


def _prior(data: bytes, params: Parameters, budget: int):
    """``api.encode``'s prior for ``data``: its byte histogram (S4's plain
    version on the host) quantized with ``budget``."""
    hist = _byte_histogram(_host_u8(data)).numpy()
    return api._prior_extra(hist, params, budget)


def draw(seed: int, index: int) -> Trial:
    """Trial ``index`` of campaign ``seed``, from ``default_rng([seed, index])``."""
    rng = np.random.default_rng([seed, index])
    cls = CLASSES[int(rng.integers(0, len(CLASSES)))]
    cfgs = CONFIGS[cls]
    params = Parameters(*cfgs[int(rng.integers(0, len(cfgs)))])
    delta = int(rng.integers(1, 256))
    k = BLOCK_SIZES[int(rng.integers(0, len(BLOCK_SIZES)))]
    low = MULTI_CHUNK_MIN_BLOCKS if index % 8 == 0 else 1
    blocks = [_block(rng, k) for _ in range(int(rng.integers(low, MAX_BLOCKS + 1)))]
    trial = Trial(seed, index, params, delta, k, blocks)
    if rng.integers(0, 2):
        # The row's total is at most the budget, below freq_max // 2: it
        # never needs the reference campaign's skip of a frozen start.
        trial.prior_budget = int(rng.integers(64, params.freq_max // 2))
        trial.prior_extra = _prior(b"".join(blocks), params, trial.prior_budget)
    return trial


def reference_blocks(blocks, params: Parameters, prior_extra, delta: int):
    """The native coder's v2 stream of each block and the blocks whose
    stream its decoder does not give back: ``(streams, {block: what the
    decoder gives, None where it raises})``."""
    streams, faults = [], {}
    for i, b in enumerate(blocks):
        s = native.compress_block_v2(b, params, prior_extra, delta)
        try:
            back = native.decompress_block_v2(s, len(b), params, prior_extra, delta)
        except ReduxError:
            back = None
        if back != b:
            faults[i] = back
        streams.append(s)
    return streams, faults


def _kernels(trial: Trial, x: KernelInputs, streams, faults) -> tuple:
    """Step 1 and 2: K1-K5 on the trial's blocks, K2 and K3 against the
    native coder.  Returns compare_kernels' result and, for each
    reference_fault block, whether K2's stream equals the native coder's."""
    lossy = torch.zeros(len(trial.blocks), dtype=torch.bool)
    lossy[list(faults)] = True
    try:
        res = compare_kernels(x, time_plain=False, reps=0, lossy=lossy.to(x.syms.device),
                              decode_raw=True)
    except AssertionError as e:
        raise Mismatch(trial, str(e)) from None
    words, bl, ovf = (t.cpu() for t in res["k2_triple"])
    bl_l, ovf_l = bl.tolist(), ovf.tolist()
    byts = words_to_bytes(words).numpy()
    k3 = res["k3_syms"].cpu().numpy()
    same = {}
    for i, s in enumerate(streams):
        if ovf_l[i] or bl_l[i] > 4 * x.n_words:  # no complete stream
            same[i] = False
            continue
        same[i] = byts[i, : bl_l[i]].tobytes() == s
        if i not in faults and not same[i]:
            raise Mismatch(trial, f"encode: block {i}: K2's stream differs from "
                                  "native.compress_block_v2's")
    for i, back in faults.items():
        # Past an empty interval the reference's serial coder may write
        # other bits than its block kernels (which the plain versions
        # follow, tests/test_torch_fuzz.py): K3 is held to the native
        # decoder only on the native coder's own stream.
        if same[i] and back is not None and k3[i, : len(back)].tobytes() != back:
            raise Mismatch(trial, f"decode: block {i} (reference_fault): K3 decodes the "
                                  "stream otherwise than native.decompress_block_v2")
    return res, {i: same[i] for i in faults}


def _route(trial: Trial, device: torch.device, multi_chunk: bool) -> dict:
    """Step 3: ``api.encode`` -> ``decode`` of the concatenated blocks."""
    data = b"".join(trial.blocks)
    kw = {"params": trial.params, "block_size": trial.k, "delta": trial.delta,
          "use_prior": trial.prior_budget is not None,
          "prior_budget": trial.prior_budget or api.DEFAULT_PRIOR_BUDGET}
    n_blocks = -(-len(data) // trial.k)
    chunks = api.ENC_CHUNK_BYTES, api.DEC_CHUNK_BYTES
    if multi_chunk:
        api.ENC_CHUNK_BYTES = api.DEC_CHUNK_BYTES = CHUNK_BLOCKS * trial.k
    try:
        before = launch_counts()
        arch = api.encode(data, device=device, **kw)
        after = launch_counts()
        try:
            back = api.decode(arch, device=device)
        except ReduxError:
            back = None
    finally:
        api.ENC_CHUNK_BYTES, api.DEC_CHUNK_BYTES = chunks
    n_chunks = -(-n_blocks // CHUNK_BLOCKS) if multi_chunk else 1
    if device.type == "cuda":
        encodes = sum(after[k] - before[k] for k in ("encode", "encode_fused"))
        if encodes != n_chunks:
            raise Mismatch(trial, f"api: {encodes} encode launches for {n_chunks} lane chunks")
        if arch != api.encode(data, device="cpu", **kw):
            raise Mismatch(trial, "api: the archive differs from api.encode(device='cpu')'s")
    faults = {}
    if back != data:
        # Only a block that the reference itself cannot decode may fail the crc.
        extra = _prior(data, trial.params, kw["prior_budget"]) if kw["use_prior"] else None
        blocks = [data[i : i + trial.k] for i in range(0, len(data), trial.k)]
        _, faults = reference_blocks(blocks, trial.params, extra, trial.delta)
        if not faults or back is not None:
            raise Mismatch(trial, "api: the round trip lost data on blocks the reference "
                                  f"decodes ({'crc failed' if back is None else 'wrong bytes'})")
    return {"n_chunks": n_chunks, "faults": sorted(faults)}


def _generic(trial: Trial, x: KernelInputs) -> list:
    """Step 4: the generic dense-model coders against K1 + the
    reference-format coder, and their round trip, on the first blocks.
    Returns the reference faults as ``("generic", block, whether the
    stream equals the oracle's)``."""
    p, d = trial.params, trial.delta
    g, kg = min(len(trial.blocks), GENERIC_BLOCKS), min(trial.k, GENERIC_K)
    syms = x.syms[:g, :kg].contiguous()
    lens = x.lens[:g].clamp(max=kg).contiguous()
    model = dense_torch_model(p, x.init_cum, d)
    n_words = coder.max_block_words(min(x.init_total + d * (kg + 1), p.freq_max),
                                    p.symbol_count, p, kg)
    gw, gl = encode_blocks_generic(syms, lens, model, p, n_words)
    sw, sl = coder.encode_blocks(*precompute_encode_model(syms, lens, x.init_cum, p, d), lens,
                                 p, n_words)
    if not (torch.equal(gl, sl) and torch.equal(gw, sw)):
        raise Mismatch(trial, "generic_encode: the dense model's streams differ from K1 + "
                              "coder.encode_blocks")
    back = decode_blocks_generic(gw, lens, model, p, kg).cpu().numpy()
    lens_l = lens.tolist()
    want = syms.cpu().numpy()
    streams = words_to_streams(gw.cpu().numpy().view(np.uint32), gl.tolist())
    faults = []
    for i, n in enumerate(lens_l):
        if np.array_equal(back[i, :n], want[i, :n]):
            continue
        # Only a block that the oracle cannot round trip either may fail.
        block = want[i, :n].tobytes()
        ref = oracle.compress_bytes(block, DenseModel(p, trial.init_cum, d))
        try:
            ok = oracle.decompress_bytes(ref, DenseModel(p, trial.init_cum, d)) == block
        except ReduxError:
            ok = False
        if ok:
            raise Mismatch(trial, f"generic_decode: block {i}: decode_blocks_generic does not "
                                  "give the block back, and the oracle does")
        faults.append(("generic", i, ref == streams[i]))
    return faults


def run_trial(trial: Trial, device) -> dict:
    """Run one trial on ``device``; raise :class:`Mismatch` at the first
    difference.  Returns what the summary counts, each reference fault as
    ``(where, block, whether the port's stream equals the reference's
    serial coder's)``, None for the ``api`` route's blocks."""
    device = torch.device(device)
    api._require_cuda(device)
    syms, lens = trial.arrays()
    x = KernelInputs.of_blocks(syms, lens, trial.init_cum, trial.params, trial.delta, device)
    streams, faults = reference_blocks(trial.blocks, trial.params, trial.prior_extra,
                                       trial.delta)
    res, same = _kernels(trial, x, streams, faults)
    out = {
        "class": config_class(trial.params),
        "frozen": tfreeze(x.init_total, trial.params, trial.delta) < int(lens.max()),
        "raw_blocks": res["raw_blocks"],
        "faults": [("kernels", i, same[i]) for i in sorted(faults)],
        "route_chunks": None,
        "generic": False,
    }
    if trial.index % 4 == 0:
        route = _route(trial, device, multi_chunk=trial.index % 8 == 0)
        out["route_chunks"] = route["n_chunks"]
        out["faults"] += [("api", i, None) for i in route["faults"]]
    if trial.index % 4 == 2:
        out["faults"] += _generic(trial, x)
        out["generic"] = True
    return out


def save_inputs(trial: Trial) -> str:
    """Write the trial's inputs to ``build/fuzz/``; returns the path."""
    FAIL_DIR.mkdir(parents=True, exist_ok=True)
    path = FAIL_DIR / f"seed{trial.seed}_trial{trial.index}.npz"
    syms, lens = trial.arrays()
    np.savez(path, syms=syms, lens=lens, init_cum=trial.init_cum, params=np.array(trial.cfg),
             delta=trial.delta, k=trial.k, prior_budget=trial.prior_budget or 0)
    return str(path)


def run_campaign(seed: int, trials: Optional[int] = None, minutes: Optional[float] = None,
                 device="cuda", only: Optional[int] = None) -> dict:
    """Trials ``0, 1, ...`` of ``seed`` (or trial ``only`` alone) on
    ``device`` until ``trials`` have run or ``minutes`` have passed.

    Returns the summary: trials run, trials by instantiation class,
    trials where the model froze, raw blocks, ``api`` routes and the
    multi-chunk ones, generic legs, and the ``reference_fault`` blocks.
    A :class:`Mismatch` is printed with its saved inputs and raised.
    """
    device = torch.device(device)
    api._require_cuda(device)
    deadline = time.monotonic() + minutes * 60 if minutes is not None else None
    indices = [only] if only is not None else range(trials if trials is not None else 1 << 62)
    s = {"seed": seed, "device": str(device), "trials": 0,
         "classes": dict.fromkeys(CLASSES, 0), "frozen": 0, "raw_blocks": 0,
         "trials_with_raw": 0, "api_routes": 0, "multi_chunk_routes": 0, "generic": 0,
         "reference_fault_blocks": 0, "reference_faults": []}
    t0 = time.monotonic()
    for index in indices:
        if deadline is not None and time.monotonic() >= deadline:
            break
        trial = draw(seed, index)
        try:
            r = run_trial(trial, device)
        except Mismatch as e:
            print(f"MISMATCH {e}; inputs saved to {save_inputs(trial)}; rerun: python -m "
                f"redux_tpu_torch.fuzz --seed {seed} --trial {index} --device {device.type}")
            raise
        s["trials"] += 1
        s["classes"][r["class"]] += 1
        s["frozen"] += r["frozen"]
        s["raw_blocks"] += r["raw_blocks"]
        s["trials_with_raw"] += r["raw_blocks"] > 0
        s["api_routes"] += r["route_chunks"] is not None
        s["multi_chunk_routes"] += (r["route_chunks"] or 0) > 1
        s["generic"] += r["generic"]
        for where, block, same in r["faults"]:
            print(f"reference_fault {where} block {block} (stream equal to the native "
                f"coder's: {same}): {trial.describe()}")
            s["reference_faults"].append([trial.index, where, block, same])
        s["reference_fault_blocks"] += len(r["faults"])
        if s["trials"] % 10 == 0:
            print(f"fuzz: {s['trials']} trials, {time.monotonic() - t0:.1f} s")
    s["seconds"] = time.monotonic() - t0
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m redux_tpu_torch.fuzz", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=None, help="stop after this many trials")
    ap.add_argument("--minutes", type=float, default=None,
                    help="stop after this many minutes (20 when neither bound is given)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the plain versions")
    ap.add_argument("--trial", type=int, default=None, help="run this trial alone")
    args = ap.parse_args(argv)
    minutes = 20.0 if args.trials is None and args.minutes is None else args.minutes
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("fuzz: --device cuda (the default) but torch.cuda.is_available() is false; "
              "pass --device cpu to run the plain versions", file=sys.stderr)
        return 2
    try:
        summary = run_campaign(args.seed, args.trials, minutes, args.device, args.trial)
    except Mismatch:
        return 1
    print("fuzz summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
