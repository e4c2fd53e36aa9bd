"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``redux_tpu_torch/csrc/``, checks each
against its plain PyTorch version on the card (and the fused K4 and the
model-in-kernel K5 against K2's streams), checks the golden archives of
``tests/golden_torch/``, then drives ``redux_tpu_torch.api.encode`` ->
``decode`` over 64 MiB of generated data three ways: the default route
(K1 -> K2, K3), the fused route (``REDUX_TPU_ENC_FUSED=1``: K4), and
sharded over a device list (``data_parallel_mesh()`` and two shards on
one card), plus the sharded K5 entry at the main path's shapes.  Each
route's archive must equal the default route's, each round trip must be
byte-equal, and each route must have launched its kernels (counts reset
just before it, read just after).  Phases print one line each; the line
before the last is the kernels' JSON summary (each kernel's time at the
main shapes beside its bound, ``cuda_checks.kernel_bounds``; no single
PyTorch call computes any of them, so ``library_ms`` is null) and the
last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero and prints no result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
MAIN_BYTES = 64 << 20
SEED = 2024
MAIN_PATH = ("model_values", "encode", "decode")  # kernels of the default route


def _route(name, data, ref_arch, device, launched):
    """Encode and decode ``data`` on ``device`` (one device or a list) with
    the launch counts reset just before and read just after; check the
    archive against the default route's and the round trip, and which
    kernels ``launched``; print the wall clock and host phases."""
    import redux_tpu_torch
    from redux_tpu_torch import api

    redux_tpu_torch.reset_launch_counts()
    t_enc, t_dec = {}, {}
    t0 = time.perf_counter()
    arch = api.encode(data, device=device, _timings=t_enc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = api.decode(arch, device=device, _timings=t_dec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = redux_tpu_torch.launch_counts()
    if ref_arch is not None and arch != ref_arch:
        raise AssertionError(f"{name}: archive differs from the default route's")
    if back != data:
        raise AssertionError(f"{name}: round trip is not byte-equal")
    for k, must in launched.items():
        if (launches[k] > 0) != must:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times")
    mb = len(data) / 1e6
    print(f"{name}: encode {mb / (t1 - t0):.3f} MB/s ({t1 - t0:.3f} s), decode "
          f"{mb / (t2 - t1):.3f} MB/s ({t2 - t1:.3f} s), wall clock with host work")
    print(f"{name}: encode phases s " + json.dumps({k: round(v, 4) for k, v in t_enc.items()}))
    print(f"{name}: decode phases s " + json.dumps({k: round(v, 4) for k, v in t_dec.items()}))
    print(f"{name}: launches {json.dumps(launches)}")
    return arch, launches


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
    for line in _build.resource_usage():
        print(f"ptxas: {line}")

    # Phase 3: kernels against their plain versions.
    res = cuda_checks.check_kernels(dev)
    torch.cuda.synchronize()
    for case, r in res.items():
        for k in cuda_checks.KERNELS:
            if r[k].get("raises"):
                print(f"kernels[{case}] {k}: raises {r[k]['raises']} (params off its path, "
                      "as in the reference)")
                continue
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
    main_on = {k: k in MAIN_PATH for k in redux_tpu_torch.launch_counts()}
    arch, launches = _route("main", data, None, dev, main_on)
    k_auto = api._auto_block_size(len(data))
    n_blocks = -(-len(data) // k_auto)
    print(f"main: {len(data)} bytes, {n_blocks} blocks of {k_auto}, archive {len(arch)} bytes, "
          f"ratio {len(arch) / len(data):.6f}, crc verified")

    # The kernels at the main path's shapes, against their plain versions.
    x = cuda_checks.KernelInputs(data, api.Parameters.tpu_wide(), 16, k_auto, dev)
    main_res = cuda_checks.compare_kernels(x)
    torch.cuda.synchronize()
    for k in cuda_checks.KERNELS:
        r = main_res[k]
        extra = (f", {r['ms_unsorted']:.3f} ms on lanes in block order"
                 if "ms_unsorted" in r else "")
        print(f"main-shape {k}: kernel {r['ms']:.3f} ms{extra}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes, "
              f"{r['ops']} int32 ops) ({n_blocks} x {k_auto}), equal")

    # Phase 6: the fused route (K4 in place of K1 -> K2) at real size.
    fused_on = {"model_values": False, "encode": False, "encode_fused": True, "decode": True}
    os.environ["REDUX_TPU_ENC_FUSED"] = "1"
    try:
        _, fused_launches = _route("fused", data, arch, dev, fused_on)
    finally:
        del os.environ["REDUX_TPU_ENC_FUSED"]

    # Phase 7: data parallel at real size: every visible GPU, then two
    # shards on one card; and the sharded K5 entry at the main shapes.
    from redux_tpu_torch.parallel import data_parallel_mesh, encode_blocks_m_sharded

    mesh_all = data_parallel_mesh()
    _route(f"dp[{len(mesh_all)} gpu]", data, arch, mesh_all, main_on)
    _route("dp[dev,dev]", data, arch, [dev, dev], main_on)
    redux_tpu_torch.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = encode_blocks_m_sharded(x.syms, x.lens, x.init_cum, x.params, x.n_words,
                                      [dev, dev], x.delta)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    m_launches = redux_tpu_torch.launch_counts()
    if m_launches["encode_m"] != 2:
        raise AssertionError(f"sharded encode_m: {m_launches['encode_m']} launches, not 2")
    err = cuda_checks.triple_err(sharded, main_res["k2_triple"], x.n_words)
    if err != 0:
        raise AssertionError(f"sharded encode_m differs from K2 (max |diff| {err})")
    print(f"dp encode_m over [dev, dev]: {n_blocks} x {k_auto} equal to K2's streams, "
          f"{t_m:.3f} s wall clock with host copies, launches {json.dumps(m_launches)}")
    path_launches = dict(launches, encode_fused=fused_launches["encode_fused"],
                         encode_m=m_launches["encode_m"])

    kernels = []
    for k, (source, replaces) in cuda_checks.KERNELS.items():
        err = max(main_res[k]["max_abs_err"], *(r[k]["max_abs_err"] for r in res.values()))
        r = main_res[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[k], "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound": r["bound"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
