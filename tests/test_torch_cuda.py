"""The port's CUDA kernels on an NVIDIA GPU: phases 3 and 4 of
``chip_smoke.py`` as test cases.  Marked ``cuda``; each test skips when
the machine has no CUDA device (decided inside the fixture, at run time).

Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import pathlib

import pytest
import torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden_torch"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda_device):
    from redux_tpu_torch import cuda_checks

    res = cuda_checks.check_kernels(cuda_device, n_blocks=256)
    for case in res.values():
        assert all(case[k]["max_abs_err"] == 0 for k in cuda_checks.KERNELS)


@pytest.mark.cuda
def test_goldens_on_the_card(cuda_device):
    from redux_tpu_torch import cuda_checks

    assert len(cuda_checks.check_goldens(cuda_device, GOLDEN)) >= 3


@pytest.mark.cuda
def test_main_path_launches_every_kernel(cuda_device):
    import redux_tpu_torch
    from redux_tpu_torch import testdata

    data = testdata.mixed(4 << 20, 5)
    redux_tpu_torch.reset_launch_counts()
    arch = redux_tpu_torch.encode(data, device=cuda_device)
    assert redux_tpu_torch.decode(arch, device=cuda_device) == data
    counts = redux_tpu_torch.launch_counts()
    # The default route is K1 -> K2, K3; K4 and K5 are off it.
    assert all(counts[k] > 0 for k in ("model_values", "encode", "decode")), counts
    assert counts["encode_fused"] == counts["encode_m"] == 0, counts


@pytest.mark.cuda
def test_default_device_runs_the_kernels(cuda_device):
    """With no ``device`` argument the entry points run on the card: the
    kernels launch and the archive is the CPU path's."""
    import redux_tpu_torch
    from redux_tpu_torch import testdata

    data = testdata.mixed(1 << 20, 8)
    redux_tpu_torch.reset_launch_counts()
    arch = redux_tpu_torch.encode(data)
    assert redux_tpu_torch.decode(arch) == data
    counts = redux_tpu_torch.launch_counts()
    assert counts["model_values"] > 0 and counts["encode"] > 0 and counts["decode"] > 0, counts
    assert arch == redux_tpu_torch.encode(data, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,delta,k", [((8, 20, 22), 16, 4096), ((8, 30, 32), 7, 1024)])
def test_decoder_sorted_and_unsorted_lanes(cuda_device, cfg, delta, k):
    """K3 on lanes in block order and sorted by coded length (the main
    path's staging) against its plain version, in both instantiations:
    reciprocal quotients at tpu_wide, u64 divisions at (8,30,32)."""
    from redux_tpu_torch import cuda_checks
    from redux_tpu_torch.ops.decode import products_fit_53
    from redux_tpu_torch.params import Parameters

    params = Parameters(*cfg)
    assert products_fit_53(params) == (cfg == (8, 20, 22))
    data = cuda_checks.phase3_data(96, k, 13)
    x = cuda_checks.KernelInputs(data, params, delta, k, cuda_device)
    res = cuda_checks.compare_kernels(x, time_plain=False, reps=1)
    assert res["decode"]["max_abs_err"] == 0
    assert res["decode"]["ms"] > 0 and res["decode"]["ms_unsorted"] > 0


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda_device):
    from redux_tpu_torch.ops.model import model_lohi
    from redux_tpu_torch.params import Parameters

    syms = torch.zeros(2, 8, dtype=torch.uint8, device=cuda_device)
    lens = torch.full((2,), 8, dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        model_lohi(syms, lens, torch.arange(258, dtype=torch.int32, device=cuda_device),
                   Parameters.tpu_wide(), 16)


@pytest.mark.cuda
def test_symbol_encoders_equal_plain_and_k2(cuda_device):
    """K4 and K5 against their plain versions and against K1 -> K2 (the
    new checks of phase 3), with the freeze engaged at tpu32."""
    from redux_tpu_torch import cuda_checks
    from redux_tpu_torch.params import Parameters

    data = cuda_checks.phase3_data(64, cuda_checks.K, 11)
    for params in (Parameters.tpu_wide(), Parameters.tpu32()):
        x = cuda_checks.KernelInputs(data, params, 16, cuda_checks.K, cuda_device)
        res = cuda_checks.compare_kernels(x, time_plain=False, reps=1)
        assert res["encode_fused"]["max_abs_err"] == 0 and res["encode_m"]["max_abs_err"] == 0


@pytest.mark.cuda
def test_symbol_encoders_refuse_8_30_32(cuda_device):
    from redux_tpu_torch import cuda_checks
    from redux_tpu_torch.params import Parameters

    data = cuda_checks.phase3_data(8, 1024, 12)
    x = cuda_checks.KernelInputs(data, Parameters.default(), 7, 1024, cuda_device)
    res = cuda_checks.compare_kernels(x, time_plain=False, reps=1)
    assert res["encode_fused"]["raises"] == res["encode_m"]["raises"] == "ValueError"


@pytest.mark.cuda
def test_fused_route_round_trip(cuda_device, monkeypatch):
    """4 MiB through ``encode`` with REDUX_TPU_ENC_FUSED=1: K4 alone
    encodes, and the archive is the default route's."""
    import redux_tpu_torch
    from redux_tpu_torch import testdata

    data = testdata.mixed(4 << 20, 6)
    default = redux_tpu_torch.encode(data, device=cuda_device)
    monkeypatch.setenv("REDUX_TPU_ENC_FUSED", "1")
    redux_tpu_torch.reset_launch_counts()
    arch = redux_tpu_torch.encode(data, device=cuda_device)
    counts = redux_tpu_torch.launch_counts()
    assert arch == default
    assert counts["encode_fused"] > 0 and counts["model_values"] == counts["encode"] == 0
    assert redux_tpu_torch.decode(arch, device=cuda_device) == data


@pytest.mark.cuda
def test_two_shards_on_one_card(cuda_device):
    """4 MiB through ``encode``/``decode`` over ``[dev, dev]``: the default
    route's archive, a byte-equal round trip, and the sharded K5 entry
    equal to K1 -> K2."""
    import redux_tpu_torch
    from redux_tpu_torch import api, cuda_checks, testdata
    from redux_tpu_torch.ops.encode import encode_blocks_ranked
    from redux_tpu_torch.parallel import encode_blocks_m_sharded

    data = testdata.mixed(4 << 20, 7)
    two = [cuda_device, cuda_device]
    arch = redux_tpu_torch.encode(data, device=two)
    assert arch == redux_tpu_torch.encode(data, device=cuda_device)
    assert redux_tpu_torch.decode(arch, device=two) == data
    x = cuda_checks.KernelInputs(data, api.Parameters.tpu_wide(), 16, 4096, cuda_device)
    args = (x.syms, x.lens, x.init_cum, x.params, x.n_words)
    ranked = encode_blocks_ranked(*args, x.delta)
    sharded = encode_blocks_m_sharded(*args, two, x.delta)
    assert cuda_checks.triple_err(sharded, ranked, x.n_words) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(101, 1022), (70, 1020), (37, 220)])
def test_odd_shapes_match_plain_versions(cuda_device, b, k):
    """B not a multiple of 32 (K4's partial last group), K not a multiple
    of 32, 8 or 4 (K2's scalar loads and last positions), a pad lane, an
    empty and a 1-byte block: every kernel equals its plain version, and K4
    and K5 equal K2's streams."""
    from redux_tpu_torch import cuda_checks

    data = cuda_checks.phase3_data(128, cuda_checks.K, 17)
    res = cuda_checks.compare_kernels(cuda_checks.odd_inputs(data, b, k, cuda_device),
                                      time_plain=False, reps=1)
    assert all(res[name]["max_abs_err"] == 0 for name in cuda_checks.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,delta,fits", [((8, 20, 22), 16, True), ((8, 30, 32), 7, False)])
def test_coder_instantiations(cuda_device, cfg, delta, fits):
    """K2 in both instantiations against its plain version: reciprocal
    quotients at tpu_wide, u64 divisions at the reference CLI's (8,30,32)."""
    from redux_tpu_torch import cuda_checks
    from redux_tpu_torch.ops.coder import products_fit_53
    from redux_tpu_torch.params import Parameters

    params = Parameters(*cfg)
    assert products_fit_53(params) == fits
    x = cuda_checks.KernelInputs(cuda_checks.phase3_data(64, 1024, 19), params, delta, 1024,
                                 cuda_device)
    res = cuda_checks.compare_kernels(x, time_plain=False, reps=1)
    assert res["encode"]["max_abs_err"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["encode_fused", "encode_m"])
def test_fused_equals_coder_at_main_shape(cuda_device, encoder):
    """K4 and K5 against K1 -> K2 at the main path's 16384 x 4096 (64 MiB)."""
    from redux_tpu_torch import cuda_checks, testdata
    from redux_tpu_torch.ops.encode import encode_blocks_ranked
    from redux_tpu_torch.params import Parameters

    kernel = cuda_checks.SYMBOL_ENCODERS[encoder][0]
    x = cuda_checks.KernelInputs(testdata.mixed(64 << 20, 2024), Parameters.tpu_wide(), 16,
                                 4096, cuda_device)
    args = (x.syms, x.lens, x.init_cum, x.params, x.n_words, x.delta)
    assert x.syms.shape == (16384, 4096)
    assert cuda_checks.triple_err(kernel(*args), encode_blocks_ranked(*args), x.n_words) == 0


@pytest.mark.cuda
def test_cli_and_auto_routes_on_the_card(cuda_device, tmp_path):
    """The CLI at its defaults ((8,30,32): K1, then K2 and K3 in their u64
    instantiations) round-trips 1 MiB through files on the card and gives
    the CPU path's archive; ``encode_auto`` -> ``decode_auto`` above the
    compact range launches three encodes and one decode."""
    import redux_tpu_torch
    from redux_tpu_torch import api, cli, testdata

    data = testdata.mixed(1 << 20, 9)
    src, arch, back = tmp_path / "in", tmp_path / "arch", tmp_path / "back"
    src.write_bytes(data)
    redux_tpu_torch.reset_launch_counts()
    assert cli.main(["-c", "-i", str(src), "-o", str(arch)]) == 0
    assert cli.main(["-d", "-i", str(arch), "-o", str(back)]) == 0
    counts = redux_tpu_torch.launch_counts()
    assert counts["model_values"] > 0 and counts["encode"] > 0 and counts["decode"] > 0, counts
    assert back.read_bytes() == data
    assert arch.read_bytes() == api.encode(data, params=api.Parameters.default(), device="cpu")
    big = testdata.mixed((1 << 20) + 4096, 10)
    redux_tpu_torch.reset_launch_counts()
    assert api.decode_auto(api.encode_auto(big, device=cuda_device), device=cuda_device) == big
    counts = redux_tpu_torch.launch_counts()
    assert (counts["model_values"], counts["encode"], counts["decode"]) == (3, 3, 1), counts


@pytest.mark.cuda
def test_degenerate_interval_input_on_the_card(cuda_device):
    """The input of ``tests/test_torch_degenerate.py`` (a byte that narrows
    to an empty interval at (8,20,22), delta 255): K1 -> K2 on the card give
    the CPU path's archive, K3 decodes its stream as its plain version does,
    and decode raises on the crc as on the CPU."""
    from redux_tpu_torch import api, container, testdata
    from redux_tpu_torch.errors import InvalidInputError
    from redux_tpu_torch.ops.coder import bytes_to_words
    from redux_tpu_torch.ops.decode import decode_blocks, decode_blocks_plain

    data = testdata.text_like(7186, 1) + bytes([111, 100, 116, 0])
    kw = {"block_size": 8192, "delta": 255, "use_prior": False}
    arch = api.encode(data, device=cuda_device, **kw)
    assert arch == api.encode(data, device="cpu", **kw)
    with pytest.raises(InvalidInputError):
        api.decode(arch, device=cuda_device)
    _, streams = container.parse_archive(arch)
    staged = torch.zeros(1, 4 * (len(streams[0]) // 4 + 3), dtype=torch.uint8)
    staged[0, : len(streams[0])] = torch.frombuffer(bytearray(streams[0]), dtype=torch.uint8)
    words = bytes_to_words(staged)
    args = (torch.tensor([len(data)], dtype=torch.int32), torch.arange(258, dtype=torch.int32),
            api.Parameters.tpu_wide(), 8192, 255)
    on_card = decode_blocks(words.to(cuda_device), *(a.to(cuda_device) if torch.is_tensor(a)
                                                      else a for a in args))
    assert torch.equal(on_card.cpu(), decode_blocks_plain(words, *args))


@pytest.mark.cuda
def test_bench_on_the_card(cuda_device):
    """Phase 9 (a) at 4 MiB: the bench verifies, its ratio is the archive's,
    and it names the kernels that launched and each one's bound."""
    from redux_tpu_torch import api, bench, testdata

    data = testdata.mixed(4 << 20, 14)
    res = bench.run_device_benchmark(data, iters=3, device=cuda_device)
    assert res["verified"] is True
    assert res["ratio"] == len(data) / len(api.encode(data, device=cuda_device))
    assert res["kernels"] == ["model_values", "encode", "decode"]
    assert set(res["roofline"]) == {"model_values", "encode", "decode"}
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in res["roofline"].values())
    assert res["h2d_pinned_gbps"] > 0 and res["h2d_pageable_gbps"] > 0


@pytest.mark.cuda
def test_generic_models_on_the_card(cuda_device):
    """Phase 9 (b) at 32 x 4096: the dense model's streams equal K1 + the
    reference-format coder, K3 and the generic decoder give back the input,
    and the static and two-speed models equal the oracle on 2 blocks."""
    import redux_tpu_torch
    from redux_tpu_torch import cuda_checks, testdata

    redux_tpu_torch.reset_launch_counts()
    res = cuda_checks.check_generic(cuda_device, testdata.mixed(32 * 4096, 15), n_blocks=32,
                                    n_oracle=2)
    counts = redux_tpu_torch.launch_counts()
    assert res["blocks"] == 32 and counts["model_values"] >= 1 and counts["decode"] >= 1, counts


@pytest.mark.cuda
def test_multihost_workers_on_the_card(cuda_device):
    """Phase 9 (c) at a small size: two workers over gloo on the card(s)
    round-trip, and the scaling worker at N = 2 verifies."""
    import json

    from redux_tpu_torch.parallel import multihost

    args = ["--device", "cuda", "--backend", "gloo"]
    outs = multihost.run_local(2, args, 300)
    assert all(f"MULTIHOST OK p{r}/2" in out for r, out in enumerate(outs)), outs
    outs = multihost.run_local(2, args + ["--scaling", "--bytes-per-host", str(1 << 20)], 300)
    assert all(json.loads(o.strip().splitlines()[-1])["verified"] for o in outs), outs


@pytest.mark.cuda
def test_fuzz_campaign_on_the_card(cuda_device):
    """Trials 0-7 of seed 0 of the randomized differential campaign: K1-K5
    against their plain versions and the native coder, two ``api`` routes
    (trial 0 over several lane chunks) and two generic legs, no mismatch."""
    import redux_tpu_torch
    from redux_tpu_torch import fuzz

    redux_tpu_torch.reset_launch_counts()
    s = fuzz.run_campaign(0, trials=8, device=cuda_device)
    assert s["trials"] == 8, s
    assert s["api_routes"] == 2 and s["multi_chunk_routes"] == 1 and s["generic"] == 2, s
    counts = redux_tpu_torch.launch_counts()
    assert all(counts[k] > 0 for k in ("model_values", "encode", "decode")), counts


@pytest.mark.cuda
@pytest.mark.parametrize("seed,index,cfg,cls", [(1, 28, (8, 20, 32), "fits53"),
                                                (8, 16, (8, 21, 32), "u64")])
def test_fuzz_trial_at_the_53_bit_edge(cuda_device, seed, index, cfg, cls):
    """One campaign trial on either side of ``products_fit_53``'s edge:
    (8,20,32), the last config whose quotients K2 and K3 take from
    reciprocals, and (8,21,32), the first with u64 divisions (there the
    ``api`` route runs several lane chunks)."""
    from redux_tpu_torch import fuzz

    trial = fuzz.draw(seed, index)
    assert trial.cfg == cfg
    res = fuzz.run_trial(trial, cuda_device)
    assert res["class"] == cls and res["route_chunks"] is not None, res


@pytest.mark.cuda
def test_nine_lane_chunks_on_the_card(cuda_device, monkeypatch):
    """Phase 11 (a) at 4 MiB: with the chunks cut to 128 blocks of 4 KiB,
    1,040 blocks take nine launches each of K1, K2 and K3 (the last of 16
    blocks); the archive is the one-chunk archive, its streams those of one
    launch over a chunk, and decode round-trips."""
    import redux_tpu_torch
    from redux_tpu_torch import api, cuda_checks, testdata

    data = testdata.mixed(1039 * 4096 + 100, 16)
    one_chunk = api.encode(data, block_size=4096, device=cuda_device)
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * 4096)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * 4096)
    redux_tpu_torch.reset_launch_counts()
    arch = api.encode(data, block_size=4096, device=cuda_device)
    assert api.decode(arch, device=cuda_device) == data
    counts = redux_tpu_torch.launch_counts()
    assert (counts["model_values"], counts["encode"], counts["decode"]) == (9, 9, 9), counts
    assert arch == one_chunk
    chunks = cuda_checks.check_chunk_streams(data, arch, cuda_device, [4, 8])
    assert [c[:2] for c in chunks] == [(512, 128), (1024, 16)]


@pytest.mark.cuda
def test_corruption_sweep_on_the_card(cuda_device):
    """Phase 11 (d) on a 64 KiB archive: every corrupted archive raises a
    ReduxError or gives back the input, through K3 on the card."""
    from redux_tpu_torch import api, cuda_checks, testdata

    data = testdata.text_like(64 << 10, 17)
    sweep = cuda_checks.corruption_sweep(data, api.encode(data, device=cuda_device),
                                         cuda_device)
    assert sweep["truncation"]["exact"] == sweep["garbage"]["exact"] == 0
    assert sweep["bit flip"]["raised"] > 0
    assert api.decode(api.encode(data, device=cuda_device), device=cuda_device) == data


@pytest.mark.cuda
def test_staging_kernels_match_plain_versions(cuda_device):
    """Phase 3 for S1-S3: 256 blocks of 4096 (raw blocks, a short last
    block) and 101 of 1022, each kernel equal to its plain version."""
    from redux_tpu_torch import cuda_checks

    res = cuda_checks.check_staging(cuda_device, n_blocks=256)
    for case in res.values():
        assert all(case[k]["max_abs_err"] == 0 for k in cuda_checks.STAGING)
    assert res["tpu_wide"]["raw_rows"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 1023, 1024, 1025, 5 * 1024 + 3, (1 << 20) + 7])
def test_crc32_kernel_equals_zlib(cuda_device, n):
    """S3 at lengths around its 1 KiB segment, on an aligned tensor and on
    a view one byte in."""
    import zlib

    import numpy as np

    from redux_tpu_torch.ops import staging

    data = np.random.default_rng(n).integers(0, 256, n + 1, dtype=np.uint8)
    t = torch.from_numpy(data).to(cuda_device)
    assert staging.crc32(t[:n]) == zlib.crc32(data[:n].tobytes())
    assert staging.crc32(t[1:]) == zlib.crc32(data[1:].tobytes())


@pytest.mark.cuda
def test_gather_and_splice_kernels_at_their_edges(cuda_device):
    """S1 with zero-length rows and rows at the full width, in both modes,
    and S2 with raw and coded blocks, equal to their plain versions; rows
    past the buffer raise before a launch."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.errors import InvalidInputError
    from redux_tpu_torch.ops import staging

    rng = np.random.default_rng(4)
    buf = torch.from_numpy(rng.integers(0, 256, 9000, dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(0, 129, 200))
    lens[:2] = torch.tensor([0, 128])
    offs = torch.from_numpy(rng.integers(0, 9000 - 128, 200))
    redux_tpu_torch.reset_launch_counts()
    for words, width in ((True, 32), (False, 128), (False, 130)):
        got = staging.gather_rows(buf.to(cuda_device), offs.to(cuda_device), lens.to(cuda_device),
                                  width, words)
        assert torch.equal(got.cpu(), staging.gather_rows(buf, offs, lens, width, words))
    with pytest.raises(InvalidInputError):
        staging.gather_rows(buf.to(cuda_device), torch.tensor([8990], device=cuda_device),
                            torch.tensor([11], device=cuda_device), 16)
    b, k, n_words = 64, 300, 20
    blocks = torch.from_numpy(rng.integers(0, 256, (b, k), dtype=np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (b, n_words))).to(torch.int32)
    klens = torch.from_numpy(rng.integers(1, k + 1, b)).to(torch.int32)
    byte_lens = torch.from_numpy(rng.integers(0, 4 * n_words + 1, b)).to(torch.int32)
    raw = torch.from_numpy(rng.integers(0, 2, b).astype(bool))
    wire = torch.where(raw, klens, byte_lens).to(torch.int64)
    args = (words, blocks, klens, byte_lens, raw, torch.cumsum(wire, 0) - wire)
    got = staging.splice_payload(*(a.to(cuda_device) for a in args), int(wire.sum()))
    assert torch.equal(got.cpu(), staging.splice_payload(*args, int(wire.sum())))
    counts = redux_tpu_torch.launch_counts()
    assert (counts["gather_rows"], counts["splice_payload"]) == (3, 1), counts


@pytest.mark.cuda
def test_api_on_the_card_equals_the_cpu_over_lane_chunks(cuda_device, monkeypatch):
    """300 blocks of 1024 with raw blocks and a short last block, the
    chunks cut to 128 blocks: the card's archive is the CPU path's, decode
    gives the input back, no plain version runs, and each kernel launches
    as often as the chunks say (S1: three chunks of words and one of raw
    rows; S3: three chunks and the decode's check)."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch import api, testdata
    from redux_tpu_torch.ops import decode, encode, model, staging

    k = 1024
    data = bytearray(testdata.text_like(300 * k - 77, 21))
    for i in np.random.default_rng(21).choice(300, 20, replace=False):
        data[i * k : (i + 1) * k] = testdata.incompressible(k, int(i))
    data = bytes(data[: 300 * k - 77])
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    want = api.encode(data, block_size=k, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    for mod, name in ((model, "model_lohi_plain"), (encode, "encode_blocks_plain"),
                      (decode, "decode_blocks_plain"), (staging, "gather_rows_plain"),
                      (staging, "splice_payload_plain"), (staging, "crc32_plain")):
        monkeypatch.setattr(mod, name, refuse)
    redux_tpu_torch.reset_launch_counts()
    arch = api.encode(data, block_size=k, device=cuda_device)
    assert api.decode(arch, device=cuda_device) == data
    assert arch == want
    counts = redux_tpu_torch.launch_counts()
    assert counts == {"model_values": 3, "encode": 3, "decode": 3, "encode_fused": 0,
                      "encode_m": 0, "gather_rows": 4, "splice_payload": 3, "crc32": 4}, counts
