"""Where a device list's call spends its time, beside one card's, on the card.

    python3 scripts/dp_costs.py [--mib 64] [--reps 7] [--devices 0 --devices 0,0 ...]

For ``--mib`` MiB of ``testdata.mixed`` (seed 2024, the input of
``chip_smoke.py``) and each device list of ``--devices`` (card indices
joined by commas; default ``0``, ``0,0`` and every card where there are
two or more), after two warm-up round trips:

- ``wall``: the wall clock of ``api.encode`` and of ``api.decode``, each
  until every card of the list is done, the median of ``--reps`` calls
  (the input and the archive verified);
- ``phases``: the ``_timings`` phases and their parts of one more call
  each way (host seconds; no mark waits for the cards);
- ``kernels``: K1 (``model_lohi``), K2 (``encode_blocks``) and K3
  (``decode_blocks`` on its lanes sorted by coded length, as ``api``
  stages them) alone on blocks already on the card, at the lane count of
  each share of the list's share plan (``api._shares``), CUDA events
  (``cuda_checks.cuda_ms``), and their sum over the shares of each card:
  the kernel time a card spends in one call;
- ``profile``: one encode and one decode under ``torch.profiler``: the
  wall clock of each, the host's ops with the most self CPU time (count
  and ms), and the device's ops' time summed (kernels, copies, fills).

Prints the card's name and power limit, then one JSON line a list.  Run
it from a checkout: it builds the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 2024
TOP_OPS = 14


def _sync(cards) -> None:
    for c in dict.fromkeys(cards):
        torch.cuda.synchronize(c)


def _wall(fn, cards, reps: int):
    """The median wall seconds of ``fn()`` until ``cards`` are done, and
    the last result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(cards)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _kernel_ms(data: bytes, k: int, lanes: list[int], card: torch.device) -> dict:
    """K1, K2 and K3 alone on the first ``m`` blocks of ``data`` on
    ``card`` for each ``m`` of ``lanes``: mean ms of 5 launches."""
    from redux_tpu_torch import api, cuda_checks
    from redux_tpu_torch.ops.decode import decode_blocks
    from redux_tpu_torch.ops.encode import encode_blocks
    from redux_tpu_torch.ops.model import model_lohi

    params = api.Parameters.tpu_wide()
    out = {}
    for m in sorted(set(lanes)):
        x = cuda_checks.KernelInputs(data[: m * k], params, api.DEFAULT_DELTA, k, card)
        p, d = x.params, x.delta
        lo, hi = model_lohi(x.syms, x.lens, x.init_cum, p, d)
        enc = (lo, hi, x.lens, x.init_total, p, x.n_words, d)
        words, bl, ovf = encode_blocks(*enc)
        skip = ovf | (bl >= x.lens)
        klens = torch.where(skip, 0, x.lens).to(torch.int32)
        coded_max = int(torch.where(skip, 0, bl).max())
        wcap = min(max(4, -(-coded_max // 4) + 2), x.n_words + 2)
        order = torch.argsort(torch.where(skip, 0, bl), stable=True)
        staged = torch.nn.functional.pad(words, (0, 2))[:, :wcap][order].contiguous()
        dec = (staged, klens[order].contiguous(), x.init_cum, p, k, d)
        if not torch.equal(decode_blocks(*dec)[~skip[order]], x.syms[order][~skip[order]]):
            raise AssertionError(f"K3 at {m} lanes did not give K2's blocks back")
        out[m] = {
            "K1": cuda_checks.cuda_ms(lambda: model_lohi(x.syms, x.lens, x.init_cum, p, d), 5),
            "K2": cuda_checks.cuda_ms(lambda: encode_blocks(*enc), 5),
            "K3": cuda_checks.cuda_ms(lambda: decode_blocks(*dec), 5),
        }
    return out


def _profile(fn, cards) -> dict:
    """``fn()`` once under ``torch.profiler``: its wall seconds, the host
    ops with the most self CPU time and the device ops' summed time."""
    from torch.profiler import ProfilerActivity, profile

    _sync(cards)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(cards)
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    host = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP_OPS]
    dev = sorted((e for e in avgs if device_us(e) > 0), key=device_us, reverse=True)
    return {
        "wall s": wall,
        "host ops (count, self ms)": {e.key: [e.count, e.self_cpu_time_total / 1e3]
                                      for e in host},
        "device ms summed": sum(device_us(e) for e in dev) / 1e3,
        "device ops (count, ms)": {e.key[:60]: [e.count, device_us(e) / 1e3] for e in dev[:8]},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--devices", action="append",
                    help="a device list, card indices joined by commas; repeat for more lists")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_costs: no CUDA device", file=sys.stderr)
        return 1
    from redux_tpu_torch import api, testdata

    n_cards = torch.cuda.device_count()
    lists = args.devices or ["0", "0,0"] + ([",".join(map(str, range(n_cards)))]
                                           if n_cards > 1 else [])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    data = testdata.mixed(args.mib << 20, SEED)
    k = api._default_block_size(len(data))
    n_blocks = -(-len(data) // k)
    for spec in lists:
        cards = [torch.device("cuda", int(i)) for i in spec.split(",")]
        dev = cards[0] if len(cards) == 1 else cards
        for _ in range(2):
            arch = api.encode(data, device=dev)
            if api.decode(arch, device=dev) != data:
                raise AssertionError(f"[{spec}]: round trip is not byte-equal")
        t_enc, arch = _wall(lambda: api.encode(data, device=dev), cards, args.reps)
        t_dec, back = _wall(lambda: api.decode(arch, device=dev), cards, args.reps)
        if back != data:
            raise AssertionError(f"[{spec}]: round trip is not byte-equal")
        del back
        ph_enc, ph_dec = {}, {}
        api.encode(data, device=dev, _timings=ph_enc)
        api.decode(arch, device=dev, _timings=ph_dec)
        steps = api._shares(n_blocks, api._lane_chunk(api.ENC_CHUNK_BYTES, k), len(cards))
        shares = [sh for step in steps for sh in step]
        per_lanes = _kernel_ms(data, k, [sh.s1 - sh.s0 for sh in shares], cards[0])
        per_card = {}
        for sh in shares:
            c = str(cards[sh.card])
            per_card[c] = per_card.get(c, 0.0) + sum(per_lanes[sh.s1 - sh.s0].values())
        print(json.dumps({
            "devices": spec, "bytes": len(data), "blocks": n_blocks, "block_size": k,
            "shares": [sh.s1 - sh.s0 for sh in shares],
            "wall": {"encode s": t_enc, "decode s": t_dec},
            "phases": {"encode": ph_enc, "decode": ph_dec},
            "kernels": {"ms at lanes": per_lanes, "K1+K2+K3 ms a card": per_card},
            "profile": {"encode": _profile(lambda: api.encode(data, device=dev), cards),
                        "decode": _profile(lambda: api.decode(arch, device=dev), cards)},
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
