"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``redux_tpu_torch/csrc/``, checks each
against its plain PyTorch version on the card, checks the golden archives
of ``tests/golden_torch/``, then drives ``redux_tpu_torch.api.encode`` ->
``decode`` over 64 MiB of generated data and verifies the round trip and
that the main path launched every kernel.  Phases print one line each; the
line before the last is the kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
MAIN_BYTES = 64 << 20
SEED = 2024


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import redux_tpu_torch
    from redux_tpu_torch import _build, api, cuda_checks, testdata

    dev = torch.device("cuda", 0)

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.lib()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s ({_build.nvcc_version()})")

    # Phase 3: kernels against their plain versions.
    res = cuda_checks.check_kernels(dev)
    torch.cuda.synchronize()
    for case, r in res.items():
        for k in cuda_checks.KERNELS:
            plain = r[k]["plain_ms"]
            print(f"kernels[{case}] {k}: equal (max |diff| {r[k]['max_abs_err']}), "
                  f"kernel {r[k]['ms']:.3f} ms, plain "
                  + (f"{plain:.3f} ms" if plain is not None else "not timed"))
        print(f"kernels[{case}]: {r['raw_blocks']} blocks stored raw")

    # Phase 4: goldens.
    for fname, n_in, n_arch in cuda_checks.check_goldens(dev, ROOT / "tests" / "golden_torch"):
        print(f"golden {fname}: {n_in} -> {n_arch} bytes, encode and decode byte-equal")
    torch.cuda.synchronize()

    # Phase 5: the main path at real size.
    data = testdata.mixed(MAIN_BYTES, SEED)
    api.encode(data[: 1 << 22], device=dev)  # warm-up: first launches, allocator
    torch.cuda.synchronize()
    redux_tpu_torch.reset_launch_counts()
    t_enc, t_dec = {}, {}
    t0 = time.perf_counter()
    arch = api.encode(data, device=dev, _timings=t_enc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = api.decode(arch, device=dev, _timings=t_dec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = redux_tpu_torch.launch_counts()
    if back != data:
        raise AssertionError("64 MiB round trip is not byte-equal")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {k}")
    k_auto = api._auto_block_size(len(data))
    n_blocks = -(-len(data) // k_auto)
    mb = len(data) / 1e6
    print(f"main: {len(data)} bytes, {n_blocks} blocks of {k_auto}, archive {len(arch)} bytes, "
          f"ratio {len(arch) / len(data):.6f}, crc verified")
    print(f"main: encode {mb / (t1 - t0):.3f} MB/s ({t1 - t0:.3f} s), decode "
          f"{mb / (t2 - t1):.3f} MB/s ({t2 - t1:.3f} s), wall clock with host work")
    print("main: encode phases s " + json.dumps({k: round(v, 4) for k, v in t_enc.items()}))
    print("main: decode phases s " + json.dumps({k: round(v, 4) for k, v in t_dec.items()}))
    print(f"main: launches {json.dumps(launches)}")

    # The kernels at the main path's shapes, against their plain versions.
    x = cuda_checks.KernelInputs(data, api.Parameters.tpu_wide(), 16, k_auto, dev)
    main_res = cuda_checks.compare_kernels(x)
    torch.cuda.synchronize()
    for k in cuda_checks.KERNELS:
        r = main_res[k]
        print(f"main-shape {k}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
              f"({n_blocks} x {k_auto}), equal")

    kernels = []
    for k, (source, replaces) in cuda_checks.KERNELS.items():
        err = max(main_res[k]["max_abs_err"], *(r[k]["max_abs_err"] for r in res.values()))
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": err,
            "ms": main_res[k]["ms"], "plain_ms": main_res[k]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
