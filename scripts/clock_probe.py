"""SM clock and board power while each of the port's five kernels runs on one card.

    python3 scripts/clock_probe.py [--seconds 1.5]

For each kernel and each shape ``scripts/ab_kernels.py`` times (1024 and
16384 blocks of 4096; tpu_wide, delta 16, the warm-start prior), launches
the kernel's wrapper back to back for ``--seconds`` while ``nvidia-smi``
samples the SM clock and the power draw every 100 ms, and prints one line:
the launches, the mean wall time a launch (host gaps included: a rate,
not a kernel time) and the median, least and largest samples of the
middle half of the window.  Tells a kernel that holds the clock at its
boost from one that the power limit slows.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from redux_tpu_torch import api, cuda_checks, testdata  # noqa: E402
from redux_tpu_torch.ops.decode import decode_blocks  # noqa: E402
from redux_tpu_torch.ops.encode import encode_blocks, encode_blocks_fused  # noqa: E402
from redux_tpu_torch.ops.encode_m import encode_blocks_m  # noqa: E402
from redux_tpu_torch.ops.model import model_lohi  # noqa: E402


def sampled(fn, seconds: float) -> str:
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            n += 10
        wall = time.perf_counter() - t0
    finally:
        smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
    rows = rows[len(rows) // 4 : 3 * len(rows) // 4] or rows
    clk = [float(r[0]) for r in rows]
    pw = [float(r[1]) for r in rows]
    return (f"{n} launches, {wall / n * 1e3:.4f} ms a launch with host gaps; SM clock MHz "
            f"median {statistics.median(clk)} (min {min(clk)}, max {max(clk)}); power W "
            f"median {statistics.median(pw)} (max {max(pw)})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("clock_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    params, delta, k = api.Parameters.tpu_wide(), 16, 4096
    for shape, data in (("1024x4096", cuda_checks.phase3_data(1024, k, 7)),
                        ("16384x4096", testdata.mixed(64 << 20, 2024))):
        x = cuda_checks.KernelInputs(data, params, delta, k, dev)
        sym = (x.syms, x.lens, x.init_cum, params, x.n_words, delta)
        lo, hi = model_lohi(*sym[:4], delta)
        enc = (lo, hi, x.lens, x.init_total, params, x.n_words, delta)
        words, bl, ovf = encode_blocks(*enc)
        klens = torch.where(ovf | (bl >= x.lens), 0, x.lens).to(torch.int32)
        dec = (torch.nn.functional.pad(words, (0, 2)), klens, x.init_cum, params, k, delta)
        runs = {
            "model_values": lambda: model_lohi(*sym[:4], delta),
            "encode": lambda: encode_blocks(*enc),
            "decode": lambda: decode_blocks(*dec),
            "encode_fused": lambda: encode_blocks_fused(*sym),
            "encode_m": lambda: encode_blocks_m(*sym),
        }
        for name, fn in runs.items():
            print(f"{shape} {name}: {sampled(fn, args.seconds)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
