"""The port's CUDA kernels on an NVIDIA GPU: phases 3 and 4 of
``chip_smoke.py`` as test cases.  Marked ``cuda``; each test skips when
the machine has no CUDA device (decided inside the fixture, at run time).

Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import pathlib

import numpy as np
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
        got = staging.gather_rows(buf.to(cuda_device), offs, lens, width, words)
        assert torch.equal(got.cpu(), staging.gather_rows(buf, offs, lens, width, words))
    with pytest.raises(InvalidInputError):
        staging.gather_rows(buf.to(cuda_device), torch.tensor([8990]), torch.tensor([11]), 16)
    with pytest.raises(ValueError):  # the offsets and lengths are the host's
        staging.gather_rows(buf.to(cuda_device), offs.to(cuda_device), lens, 16)
    b, k, n_words = 64, 300, 20
    blocks = torch.from_numpy(rng.integers(0, 256, (b, k), dtype=np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (b, n_words))).to(torch.int32)
    klens = torch.from_numpy(rng.integers(1, k + 1, b)).to(torch.int32)
    byte_lens = torch.from_numpy(rng.integers(0, 4 * n_words + 1, b)).to(torch.int32)
    raw = torch.from_numpy(rng.integers(0, 2, b).astype(bool))
    wire = torch.where(raw, klens, byte_lens)
    got = staging.splice_payload(words.to(cuda_device), blocks.to(cuda_device), raw, wire)
    assert torch.equal(got.cpu(), staging.splice_payload(words, blocks, raw, wire))
    counts = redux_tpu_torch.launch_counts()
    assert (counts["gather_rows"], counts["splice_payload"]) == (3, 1), counts


@pytest.mark.cuda
def test_api_on_the_card_equals_the_cpu_over_lane_chunks(cuda_device, monkeypatch):
    """300 blocks of 1024 with raw blocks and a short last block, the
    chunks cut to 128 blocks: the card's archive is the CPU path's, decode
    gives the input back, no plain version runs, and each kernel launches
    as often as the chunks say (encode: K1, K2, S2 and S3 once a chunk;
    decode, a range of blocks a chunk: K3 and S1 (words) once a range with
    coded blocks, S1 (bytes) once a range with raw blocks, S3 once a
    range)."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch import api, container, testdata
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
    raw = np.asarray(container.parse_archive(arch, with_streams=False)[0].block_raw)
    ranges = [raw[s0 : s0 + 128] for s0 in range(0, 300, 128)]
    coded = sum(bool((~r).any()) for r in ranges)
    with_raw = sum(bool(r.any()) for r in ranges)
    assert coded == 3 and with_raw >= 2
    assert counts == {"model_values": 3, "encode": 3, "decode": coded, "encode_fused": 0,
                      "encode_m": 0, "gather_rows": coded + with_raw, "splice_payload": 3,
                      "crc32": 3 + 3}, counts


@pytest.mark.cuda
def test_decode_device_memory_is_flat_over_chunks(cuda_device, monkeypatch):
    """With ``DEC_CHUNK_BYTES`` at 128 x 4096, decode 8 and 32 ranges of
    128 blocks: the allocator's peak during each decode (above what was
    allocated before it) stays under two chunk slots reckoned from the
    chunk's shapes (``cuda_checks.decode_memory_bound``: the largest
    slice, 128 rows of staged words, K3's symbols and the output, twice),
    and the 32-range peak is within 5% of the 8-range peak.  K3 and S1
    (words) launch once a range with coded blocks, S1 (bytes) once a range
    with raw blocks, S3 once a range, and no plain version runs."""
    import redux_tpu_torch
    from redux_tpu_torch import api, container, cuda_checks, testdata
    from redux_tpu_torch.ops import decode, staging

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * 4096)
    k, peaks = 4096, []
    for n_ranges in (8, 32):
        data = testdata.mixed(n_ranges * 128 * k - 100, 31)
        arch = api.encode(data, block_size=k, device=cuda_device)
        header = container.parse_table(arch)
        assert api.decode(arch, device=cuda_device) == data  # warm-up: pinned slots, allocator
        with monkeypatch.context() as m:
            for mod, name in ((decode, "decode_blocks_plain"), (staging, "gather_rows_plain"),
                              (staging, "crc32_plain")):
                m.setattr(mod, name, refuse)
            torch.cuda.synchronize(cuda_device)
            before = torch.cuda.memory_allocated(cuda_device)
            torch.cuda.reset_peak_memory_stats(cuda_device)
            redux_tpu_torch.reset_launch_counts()
            back = api.decode(arch, device=cuda_device)
            torch.cuda.synchronize(cuda_device)
            counts = redux_tpu_torch.launch_counts()
            peak = torch.cuda.max_memory_allocated(cuda_device) - before
        assert back == data
        ranges = [header.raw[s0 : s0 + 128] for s0 in range(0, header.n_blocks, 128)]
        assert len(ranges) == n_ranges
        coded = sum(bool((~r).any()) for r in ranges)
        with_raw = sum(bool(r.any()) for r in ranges)
        assert with_raw > 0
        assert counts == dict.fromkeys(counts, 0) | {
            "decode": coded, "gather_rows": coded + with_raw, "crc32": n_ranges}, counts
        bound = cuda_checks.decode_memory_bound(header)
        assert 0 < peak <= bound, (n_ranges, peak, bound)
        peaks.append(peak)
    assert abs(peaks[1] - peaks[0]) <= 0.05 * peaks[0], peaks


@pytest.mark.cuda
def test_encode_device_memory_is_flat_over_chunks(cuda_device, monkeypatch):
    """With ``ENC_CHUNK_BYTES`` at 128 x 4096, encode 8 and 32 chunks of
    128 blocks: the allocator's peak during each encode (above what was
    allocated before it) stays under the reckoning from one chunk's shapes
    (``cuda_checks.encode_memory_bound``: two input slots, K1's planes,
    K2's words and a payload), and the 32-chunk peak is within 5% of the
    8-chunk peak.  K1, K2, S2 and S3 launch once a chunk, no plain version
    runs, and the archive is the CPU path's."""
    import redux_tpu_torch
    from redux_tpu_torch import api, cuda_checks, testdata
    from redux_tpu_torch.ops import encode, model, staging

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * 4096)
    k, peaks = 4096, []
    for n_chunks in (8, 32):
        data = testdata.mixed(n_chunks * 128 * k - 100, 37)
        want = api.encode(data, block_size=k, device="cpu") if n_chunks == 8 else None
        api.encode(data, block_size=k, device=cuda_device)  # warm-up: pinned slots, allocator
        with monkeypatch.context() as m:
            for mod, name in ((model, "model_lohi_plain"), (encode, "encode_blocks_plain"),
                              (staging, "splice_payload_plain"), (staging, "crc32_plain")):
                m.setattr(mod, name, refuse)
            torch.cuda.synchronize(cuda_device)
            before = torch.cuda.memory_allocated(cuda_device)
            torch.cuda.reset_peak_memory_stats(cuda_device)
            redux_tpu_torch.reset_launch_counts()
            arch = api.encode(data, block_size=k, device=cuda_device)
            torch.cuda.synchronize(cuda_device)
            counts = redux_tpu_torch.launch_counts()
            peak = torch.cuda.max_memory_allocated(cuda_device) - before
        if want is not None:
            assert arch == want
        assert api.decode(arch, device=cuda_device) == data
        assert counts == dict.fromkeys(counts, 0) | {
            "model_values": n_chunks, "encode": n_chunks, "splice_payload": n_chunks,
            "crc32": n_chunks}, counts
        bound = cuda_checks.encode_memory_bound(len(data), k, api.Parameters.tpu_wide())
        assert 0 < peak <= bound, (n_chunks, peak, bound)
        peaks.append(peak)
    assert abs(peaks[1] - peaks[0]) <= 0.05 * peaks[0], peaks


@pytest.mark.cuda
def test_a_failing_pin_raises(cuda_device, monkeypatch):
    """Where host memory cannot be pinned, ``encode`` and ``decode`` on the
    card raise; neither copies pageable memory instead."""
    from redux_tpu_torch import api, testdata

    data = testdata.mixed(3 << 20, 41)
    arch = api.encode(data, device=cuda_device)

    def fail(n):
        raise RuntimeError("cannot pin")

    monkeypatch.setattr(api, "_pinned", fail)
    with pytest.raises(RuntimeError, match="cannot pin"):
        api.encode(data, device=cuda_device)
    with pytest.raises(RuntimeError, match="cannot pin"):
        api.decode(arch, device=cuda_device)
    monkeypatch.undo()
    assert api.decode(arch, device=cuda_device) == data


SEG, TILE = 256, 256 * 512  # ops.staging.CRC_SEGMENT, CRC_SEGMENT * CRC_THREADS


@pytest.mark.cuda
@pytest.mark.parametrize("n", [SEG - 1, SEG, SEG + 1, 32 * SEG - 1, 32 * SEG, 32 * SEG + 1,
                               TILE - 1, TILE, TILE + 1, 133 * TILE + 5])
def test_crc32_kernel_at_segment_warp_and_tile_edges(cuda_device, n):
    """S3 around its 256-byte segment, a warp's 32 segments, a CTA's 128
    KiB tile and past one tile a CTA (133 tiles), on views 0-15 bytes in:
    equal to its plain version and to ``zlib.crc32``; one launch a call."""
    import zlib

    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.ops import staging

    assert (staging.CRC_SEGMENT, staging.CRC_SEGMENT * staging.CRC_THREADS) == (SEG, TILE)
    data = np.random.default_rng(n).integers(0, 256, n + 16, dtype=np.uint8)
    t = torch.from_numpy(data).to(cuda_device)
    redux_tpu_torch.reset_launch_counts()
    for a in range(16):
        want = zlib.crc32(data[a : a + n].tobytes())
        assert staging.crc32(t[a : a + n]) == want, a
    assert staging.crc32_plain(t[3 : 3 + n]) == zlib.crc32(data[3 : 3 + n].tobytes())
    assert redux_tpu_torch.launch_counts()["crc32"] == 16


@pytest.mark.cuda
def test_crc32_kernel_at_256_mib(cuda_device):
    """S3 over 256 MiB (an encode chunk) and a view 5 bytes in, against
    ``zlib.crc32``; ``crc32_device`` into a slot of a tensor leaves the
    same bits there without a wait, and the slots combine as ``api``
    combines its chunks."""
    import zlib

    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.ops import staging

    n = 256 << 20
    data = np.random.default_rng(256).integers(0, 256, n, dtype=np.uint8)
    t = torch.from_numpy(data).to(cuda_device)
    redux_tpu_torch.reset_launch_counts()
    assert staging.crc32(t) == zlib.crc32(data)
    assert staging.crc32(t[5:]) == zlib.crc32(data[5:])
    slots = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    staging.crc32_device(t[: n // 3], slots[0:1])
    staging.crc32_device(t[n // 3 :], slots[1:2])
    assert redux_tpu_torch.launch_counts()["crc32"] == 4
    crc = staging.combine_crcs(slots.cpu().to(torch.int64) & 0xFFFFFFFF,
                               torch.tensor([n - n // 3, 0]))
    assert crc == zlib.crc32(data)
    with pytest.raises(ValueError):  # a slot of two ints: refused before a launch
        staging.crc32_device(t, slots)
    assert redux_tpu_torch.launch_counts()["crc32"] == 4


HIST_LENGTHS = (1, 15, 16, 17, 4099, 21_504, 768_771, (64 << 20) + 3)


def _hist_input(kind: str, n: int, dev: torch.device) -> torch.Tensor:
    """``n`` bytes of a content kind on ``dev``: ``testdata``'s generators,
    or one byte value throughout (``zeros``, ``run_61``)."""
    from redux_tpu_torch import testdata

    if kind in ("zeros", "run_61"):
        return torch.full((n,), 0 if kind == "zeros" else 0x61, dtype=torch.uint8, device=dev)
    data = getattr(testdata, kind)(n, 2024)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text_like", "mixed", "incompressible", "zeros", "run_61"])
def test_byte_histogram_kernel_equals_np_bincount(cuda_device, kind):
    """S4 against ``np.bincount``, tolerance 0: 1 byte to 64 MiB + 3 at
    starts 0-15 bytes past a 16-byte boundary, then 256 MiB + 7 (an encode
    chunk and a tail) at starts 0 and 5; one byte value throughout as
    well as text, mixed and incompressible bytes.  Each call adds into a
    row that already holds counts; one launch a call."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.errors import InvalidInputError
    from redux_tpu_torch.ops import staging

    big = (256 << 20) + 7
    t = _hist_input(kind, big + 16, cuda_device)
    host = t.cpu().numpy()
    redux_tpu_torch.reset_launch_counts()
    calls = 0
    for n in HIST_LENGTHS:
        for a in range(16) if n < (1 << 20) else (0, 1, 7, 15):
            row = torch.arange(256, dtype=torch.int64, device=cuda_device)
            got = staging.byte_histogram(t[a : a + n], row).cpu().numpy() - np.arange(256)
            assert np.array_equal(got, np.bincount(host[a : a + n], minlength=256)), (n, a)
            calls += 1
    for a in (0, 5):
        got = staging.byte_histogram(t[a : a + big], torch.zeros_like(row)).cpu().numpy()
        assert np.array_equal(got, np.bincount(host[a : a + big], minlength=256)), (big, a)
        calls += 1
    if kind in ("zeros", "run_61"):
        assert got[0 if kind == "zeros" else 0x61] == big
    assert redux_tpu_torch.launch_counts()["histogram"] == calls
    assert staging.byte_histogram(t[:0], row) is row  # an empty tensor launches nothing
    with pytest.raises(InvalidInputError):  # a row on the host: refused
        staging.byte_histogram(t[:16], torch.zeros(256, dtype=torch.int64))
    assert redux_tpu_torch.launch_counts()["histogram"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dev_dev", "every_card"])
def test_byte_histogram_on_each_card_of_a_list(cuda_device, which):
    """S4 on each card of a device list, into that card's own row, equal to
    ``np.bincount``; each card counts its own launches."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch import testdata
    from redux_tpu_torch.ops import staging

    data = testdata.text_like((3 << 20) + 5, 29)
    want = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    devices = _device_list(which, cuda_device)
    redux_tpu_torch.reset_launch_counts()
    for d in devices:
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(d)
        got = staging.byte_histogram(t[1:], torch.zeros(256, dtype=torch.int64, device=d))
        assert got.device == t.device
        assert np.array_equal(got.cpu().numpy(), want - np.bincount([data[0]], minlength=256))
    for d in dict.fromkeys(devices):
        assert redux_tpu_torch.launch_counts(d)["histogram"] == devices.count(d)


@pytest.mark.cuda
def test_main_path_counts_bytes_on_the_card_once_a_share(cuda_device, monkeypatch):
    """``api.encode`` of 1 MiB of ``mixed`` over two lane chunks (cut to
    128 blocks of 4096): S4 launches once a share on card 0, neither
    ``torch.bincount`` nor the plain version runs, and the archive is the
    CPU path's byte for byte."""
    from redux_tpu_torch import _build, api, testdata
    from redux_tpu_torch.ops import staging

    k = 4096
    data = testdata.mixed((1 << 20) - 999, 31)
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    want = api.encode(data, block_size=k, device="cpu")
    n_shares = sum(len(step) for step in api._shares(-(-len(data) // k), 128, 1))
    assert n_shares == 2

    def refuse(*args, **kwargs):
        raise AssertionError("the card's path counted bytes off the kernel")

    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(staging, "byte_histogram_plain", refuse)
    _build.card_launches.clear()
    arch = api.encode(data, block_size=k, device=cuda_device)
    assert _build.card_launches["histogram", 0] == n_shares
    assert arch == want
    monkeypatch.undo()
    assert api.decode(arch, device=cuda_device) == data


def _splice_case(rng, b, k, n_words, wire, raw):
    blocks = torch.from_numpy(rng.integers(0, 256, (b, k), dtype=np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (b, n_words))).to(torch.int32)
    cap = np.where(raw, k, 4 * n_words)
    return (words, blocks, torch.from_numpy(raw),
            torch.from_numpy(np.minimum(wire, cap).astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tiny_rows", "all_raw", "all_coded", "ragged_1022",
                                   "65536_blocks"])
def test_splice_kernel_shapes(cuda_device, shape):
    """S2 against its plain version, tolerance 0: runs of rows of 0-3
    bytes (a 16-byte piece across several rows; a total that is not a
    multiple of 16), all raw, all coded, 1022-byte blocks, and 65,536
    blocks of 4096 (an encode chunk, 0-4160 bytes a row); one launch a
    call."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.ops import staging

    rng = np.random.default_rng(len(shape))
    b, k, n_words = {"tiny_rows": (5000, 64, 20), "all_raw": (512, 4096, 1040),
                     "all_coded": (512, 4096, 1040), "ragged_1022": (301, 1022, 260),
                     "65536_blocks": (65536, 4096, 1040)}[shape]
    wire = {"tiny_rows": rng.integers(0, 4, b)}.get(shape, rng.integers(0, 4 * n_words + 1, b))
    raw = {"all_raw": np.ones(b, bool), "all_coded": np.zeros(b, bool)}.get(
        shape, rng.integers(0, 2, b).astype(bool))
    words, blocks, raw_t, wire_t = _splice_case(rng, b, k, n_words, wire, raw)
    want = staging.splice_payload_plain(words.to(cuda_device), blocks.to(cuda_device), raw_t,
                                        wire_t)
    redux_tpu_torch.reset_launch_counts()
    got = staging.splice_payload(words.to(cuda_device), blocks.to(cuda_device), raw_t, wire_t)
    torch.cuda.synchronize(cuda_device)
    assert redux_tpu_torch.launch_counts()["splice_payload"] == 1
    assert got.shape == (int(wire_t.sum()),)
    if shape == "tiny_rows":
        assert got.shape[0] % 16 != 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_splice_kernel_refuses_malformed_rows(cuda_device):
    """A negative length, a coded stream past K2's buffer, a raw block past
    ``k``, or the lengths on the card instead of the host: refused before
    any launch (InvalidInputError, or ValueError for the device)."""
    import numpy as np

    import redux_tpu_torch
    from redux_tpu_torch.errors import InvalidInputError
    from redux_tpu_torch.ops import staging

    rng = np.random.default_rng(9)
    raw = np.array([True, False, False, True])
    words, blocks, raw_t, wire_t = _splice_case(rng, 4, 64, 4, np.array([64, 16, 3, 1]), raw)
    words, blocks = words.to(cuda_device), blocks.to(cuda_device)
    redux_tpu_torch.reset_launch_counts()
    for row, length in ((2, -1), (1, 17), (0, 65)):
        bad = wire_t.clone()
        bad[row] = length
        with pytest.raises(InvalidInputError):
            staging.splice_payload(words, blocks, raw_t, bad)
    with pytest.raises(ValueError):
        staging.splice_payload(words, blocks, raw_t, wire_t.to(cuda_device))
    with pytest.raises(ValueError):  # int64 lengths: the header's are int32
        staging.splice_payload(words, blocks, raw_t, wire_t.to(torch.int64))
    assert redux_tpu_torch.launch_counts()["splice_payload"] == 0
    assert staging.splice_payload(words, blocks, raw_t, wire_t).shape == (84,)


@pytest.mark.cuda
@pytest.mark.parametrize("align", [0, 1, 7, 15])
def test_gather_kernel_edge_cases(cuda_device, align):
    """S1 equal to its plain version on a buffer 0, 1, 7 or 15 bytes into
    a 16-byte boundary: offsets at every residue mod 16, rows ending at
    the buffer's last byte, empty and full rows, widths off 4 and 16 (and
    under 16 bytes), wide raw rows taken by teams of warps
    (``cuda_checks.gather_edge_cases``)."""
    from redux_tpu_torch import cuda_checks

    rng = np.random.default_rng(align)
    buf = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 16, dtype=np.uint8)).to(cuda_device)
    cases = cuda_checks.gather_edge_cases(buf[align:], (16384, 4096, 1022, 37, 3),
                                          (1024, 491, 13, 1), seed=align)
    assert cases == 4 * 9


@pytest.mark.cuda
def test_results_are_prefaulted_on_the_card(cuda_device, monkeypatch):
    """On the card's path too, encode prefaults the header and each
    chunk's payload and decode each range's output, on the worker threads
    (a byte a page: no kernel hint needed, so every machine allows it):
    the ranges tile each result exactly, and the results are right."""
    from redux_tpu_torch import api, testdata

    touched = []
    real = api._touch_pages
    monkeypatch.setattr(api, "_touch_pages", lambda arr, a, b: touched.append((a, b))
                        or real(arr, a, b))
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * 4096)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * 4096)
    data = testdata.mixed(3 * 128 * 4096 - 100, 41)
    want = api.encode(data, block_size=4096, device="cpu")
    touched.clear()
    arch = api.encode(data, block_size=4096, device=cuda_device)
    assert arch == want
    for length in (len(arch), len(data)):
        spans = sorted(touched)
        assert spans[0][0] == 0 and spans[-1][1] == length
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
        touched.clear()
        if length == len(arch):
            assert api.decode(arch, device=cuda_device) == data


def _device_list(which: str, dev: torch.device) -> list:
    """``[dev, dev]`` (two shares a step on one card) or every card; skips
    the latter on a machine of one card."""
    if which == "dev_dev":
        return [dev, dev]
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dev_dev", "every_card"])
def test_device_lists_on_the_card(cuda_device, monkeypatch, which):
    """700 blocks of 1024 with the chunks cut to 128 blocks (several steps,
    a share of raw blocks only, a short last block) over a device list:
    the archive is one card's and the CPU path's, decode gives the input
    back, no plain version runs, and each card launches each kernel as
    often as the share plan gives it; a flipped byte in every share's
    slice raises."""
    import redux_tpu_torch
    from redux_tpu_torch import api, container, testdata
    from redux_tpu_torch.errors import InvalidInputError
    from redux_tpu_torch.ops import decode, encode, model, staging

    k = 1024
    devices = _device_list(which, cuda_device)
    data = bytearray(testdata.text_like(700 * k - 77, 23))
    for i in [*range(128, 256), *np.random.default_rng(23).choice(700, 30, replace=False)]:
        data[i * k : (i + 1) * k] = testdata.incompressible(k, int(i))
    data = bytes(data[: 700 * k - 77])
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    want = api.encode(data, block_size=k, device="cpu")
    assert api.encode(data, block_size=k, device=cuda_device) == want

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    for mod, name in ((model, "model_lohi_plain"), (encode, "encode_blocks_plain"),
                      (decode, "decode_blocks_plain"), (staging, "gather_rows_plain"),
                      (staging, "splice_payload_plain"), (staging, "crc32_plain"),
                      (staging, "byte_histogram_plain")):
        monkeypatch.setattr(mod, name, refuse)
    cards = api._cards(devices)
    redux_tpu_torch.reset_launch_counts()
    arch = api.encode(data, block_size=k, device=devices)
    assert arch == want
    assert api.decode(arch, device=devices) == data
    header = container.parse_table(arch)
    steps = api._shares(header.n_blocks, 128, len(cards))
    want_counts = {d: dict.fromkeys(redux_tpu_torch.launch_counts(), 0) for d in cards}
    for sh in (sh for step in steps for sh in step):
        w, raw = want_counts[cards[sh.card]], header.raw[sh.s0 : sh.s1]
        coded = int((~raw).any())
        for name in ("model_values", "encode", "splice_payload", "histogram"):
            w[name] += 1
        w["decode"] += coded
        w["gather_rows"] += coded + int(raw.any())
        w["crc32"] += 2
    assert {d: redux_tpu_torch.launch_counts(d) for d in cards} == want_counts
    assert any(header.raw[sh.s0 : sh.s1].all() for step in steps for sh in step)
    ends = api._stream_ends(header, api._decode_lanes(header))
    for sh in (sh for step in steps for sh in step):
        bad = bytearray(arch)
        bad[(int(header.stream_offs[sh.s0]) + int(ends[sh.s1 - 1])) // 2] ^= 0x20
        with pytest.raises(InvalidInputError):
            api.decode(bytes(bad), device=devices)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dev_dev", "every_card"])
def test_device_lists_at_one_step_and_timed(cuda_device, which):
    """4 MiB over a device list in one step (each card keeps its share's
    blocks for pass 2): one card's archive and a byte-equal round trip,
    with and without ``_timings``."""
    from redux_tpu_torch import api, testdata

    devices = _device_list(which, cuda_device)
    data = testdata.mixed(4 << 20, 29)
    want = api.encode(data, device=cuda_device)
    t_enc, t_dec = {}, {}
    assert api.encode(data, device=devices) == want
    assert api.encode(data, device=devices, _timings=t_enc) == want
    assert api.decode(want, device=devices) == data
    assert api.decode(want, device=devices, _timings=t_dec) == data
    assert {"pass1", "pass2", "header"} <= set(t_enc) and "kernels" in t_dec


@pytest.mark.cuda
def test_recorded_calls_on_the_card(cuda_device, monkeypatch, tmp_path):
    """4 MiB in eight shares each way, recorded: the bus bytes of each
    call equal the bytes of its host <-> card copies in the profiler's
    trace (the CUDA runtime's own count) and their closed form; with
    ``torch.cuda.synchronize`` refused, the archive and the round trip of
    an unrecorded call, every part marked (the pinned slots and their
    waits too) and the spans tiling each call
    (``tests/test_torch_recorder.py``)."""
    import json

    from redux_tpu_torch import api, testdata
    from test_torch_recorder import PARTS, bus_bytes

    data = testdata.mixed(4 << 20, 37)
    k = api._default_block_size(len(data))
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    want = api.encode(data, device=cuda_device)
    assert api.decode(want, device=cuda_device) == data
    calls = {"enc": lambda t: api.encode(data, device=cuda_device, _timings=t),
             "dec": lambda t: api.decode(want, device=cuda_device, _timings=t)}
    counted, copied = {}, {}
    for kind, call in calls.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call({})
        rec = api.recorded_calls()[-1]
        counted[kind] = (rec["h2d"], rec["d2h"])
        prof.export_chrome_trace(str(tmp_path / f"{kind}.json"))
        events = json.loads((tmp_path / f"{kind}.json").read_text())["traceEvents"]
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        copied[kind] = tuple(sum(e["args"]["bytes"] for e in copies if way in e["name"])
                             for way in ("HtoD", "DtoH"))
    assert counted == copied
    assert counted == bus_bytes(data, want, cuda_device, k, 128)

    def refuse(*args, **kwargs):
        raise AssertionError("a recorded call synchronized the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    t_enc, t_dec = {}, {}
    assert api.encode(data, device=cuda_device, _timings=t_enc) == want
    rec_enc = api.recorded_calls()[-1]
    assert api.decode(want, device=cuda_device, _timings=t_dec) == data
    rec_dec = api.recorded_calls()[-1]
    assert {s[1] for rec in (rec_enc, rec_dec) for s in rec["spans"]} == PARTS
    for rec in (rec_enc, rec_dec):
        spans = rec["spans"]
        assert all(a[3] == b[2] for a, b in zip(spans, spans[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dev_dev", "every_card"])
def test_recorded_calls_by_card(cuda_device, monkeypatch, tmp_path, which):
    """4 MiB over a device list in several shares a card, recorded: each
    entry's bus bytes equal their closed form, and summed over the entries
    on one card, the bytes of that card's host <-> card copies in the
    profiler's trace; every entry's parts end in ``@j``."""
    import json

    from redux_tpu_torch import api, testdata
    from test_torch_recorder import bus_bytes_by_card

    devices = _device_list(which, cuda_device)
    data = testdata.mixed(4 << 20, 41)
    k = api._default_block_size(len(data))
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", 128 * k)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", 128 * k)
    want = api.encode(data, device=devices)  # S3's constants go up to each card here
    assert api.decode(want, device=devices) == data
    calls = {"enc": lambda t: api.encode(data, device=devices, _timings=t),
             "dec": lambda t: api.decode(want, device=devices, _timings=t)}
    closed = bus_bytes_by_card(data, want, devices, k, 128)
    for kind, call in calls.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call({})
        rec = api.recorded_calls()[-1]
        assert list(zip(rec["h2d_by_card"], rec["d2h_by_card"])) == closed[kind], kind
        prof.export_chrome_trace(str(tmp_path / f"{kind}.json"))
        events = json.loads((tmp_path / f"{kind}.json").read_text())["traceEvents"]
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        for card in {d.index for d in devices}:
            on = [j for j, d in enumerate(devices) if d.index == card]
            copied = tuple(sum(e["args"]["bytes"] for e in copies
                               if way in e["name"] and e["args"].get("device", e.get("pid")) == card)
                           for way in ("HtoD", "DtoH"))
            assert copied == (sum(rec["h2d_by_card"][j] for j in on),
                              sum(rec["d2h_by_card"][j] for j in on)), (kind, card)
        tags = {s[1].partition("@")[2] for s in rec["spans"]} - {""}
        assert tags == {str(j) for j in range(len(devices))}


@pytest.fixture(scope="module")
def route_inputs():
    """16,384 blocks of ``cuda_checks.phase3_data`` (4096 bytes, seed 23)
    coded by K1 -> K2 in both instantiations, with their plain decode:
    per configuration ``(params, words, klens, init_cum, plain)``, the
    words padded by two zero words and blocks stored raw given length 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from redux_tpu_torch import cuda_checks
    from redux_tpu_torch.ops.decode import decode_blocks_plain
    from redux_tpu_torch.ops.encode import encode_blocks
    from redux_tpu_torch.ops.model import model_lohi
    from redux_tpu_torch.params import Parameters

    dev, k, delta = torch.device("cuda", 0), 4096, 16
    data = cuda_checks.phase3_data(16384, k, 23)
    out = {}
    for cfg in ((8, 20, 22), (8, 30, 32)):
        params = Parameters(*cfg)
        x = cuda_checks.KernelInputs(data, params, delta, k, dev)
        lo, hi = model_lohi(x.syms, x.lens, x.init_cum, params, delta)
        words, bl, ovf = encode_blocks(lo, hi, x.lens, x.init_total, params, x.n_words, delta)
        del lo, hi
        klens = torch.where(ovf | (bl >= x.lens), 0, x.lens).to(torch.int32)
        words = torch.nn.functional.pad(words, (0, 2)).contiguous()
        plain = decode_blocks_plain(words, klens, x.init_cum, params, k, delta)
        assert torch.equal(plain[klens > 0], x.syms[klens > 0])
        out[cfg] = (params, words, klens, x.init_cum, plain)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [(8, 20, 22), (8, 30, 32)])
@pytest.mark.parametrize("at", ["1", "6", "188", "threshold", "threshold+1", "16384"])
def test_decoder_routes_agree(cuda_device, route_inputs, cfg, at):
    """K3's warp and thread routes, each forced, decode the first B blocks
    to the plain version's symbols, in both instantiations; the default
    takes the warp route up to ``warp_route_max`` blocks and the thread
    route past it; ``_build.route_blocks`` counts each launch's blocks
    under its route and card, and ``launch_counts`` one launch a call."""
    import redux_tpu_torch
    from redux_tpu_torch import _build
    from redux_tpu_torch.ops.decode import decode_blocks, warp_route_max

    params, words, klens, ic, plain = route_inputs[cfg]
    thr = warp_route_max(cuda_device)
    b = {"threshold": thr, "threshold+1": thr + 1}.get(at) or int(at)
    args = (words[:b], klens[:b], ic, params, 4096, 16)
    for route in ("warp", "thread", None):
        before = _build.route_blocks.copy()
        redux_tpu_torch.reset_launch_counts()
        got = decode_blocks(*args, _route=route)
        assert torch.equal(got, plain[:b]), route
        assert redux_tpu_torch.launch_counts(cuda_device)["decode"] == 1
        taken = route or ("warp" if b <= thr else "thread")
        after = _build.route_blocks - before
        assert dict(after) == {(taken, cuda_device.index): b}, route


@pytest.mark.cuda
def test_calgary_sized_files_take_the_warp_route(cuda_device):
    """A round trip of a Calgary-sized input (768,771 bytes, book1's size:
    188 blocks of 4096) through ``api``: every coded block is decoded on
    the warp route, and the recorded call says so; 16,384 + 1 blocks take
    the thread route."""
    from redux_tpu_torch import api, testdata
    from redux_tpu_torch.ops.decode import warp_route_max

    data = testdata.text_like(768_771, 31)
    arch = api.encode(data, device=cuda_device)
    header = api.container.parse_table(arch)
    coded = int((~api._decode_lanes(header).raw).sum())
    assert header.n_blocks == 188 and coded > 0
    assert api.decode(arch, device=cuda_device, _timings={}) == data
    rec = api.recorded_calls()[-1]
    assert (rec["warp_blocks"], rec["thread_blocks"]) == (coded, 0)
    big = testdata.text_like(16384 * 4096 + 1, 32)
    arch = api.encode(big, block_size=4096, device=cuda_device)
    assert api.decode(arch, device=cuda_device, _timings={}) == big
    rec = api.recorded_calls()[-1]
    coded = int((~api._decode_lanes(api.container.parse_table(arch)).raw).sum())
    assert coded > warp_route_max(cuda_device)
    assert (rec["warp_blocks"], rec["thread_blocks"]) == (0, coded)
