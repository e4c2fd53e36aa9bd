"""The arithmetic of the metrics: card time, copy time, the roofline
shares and the reduction of a trace."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import readers, trace, work
from benchmark.run import Run


def make_run(calls, trace_=None, n_cards=1):
    run = Run({}, {}, {}, n_cards)
    run.calls = calls
    run.trace = trace_
    return run


def call(kind, mode, nbytes, seconds, file=0):
    return dict(kind=kind, mode=mode, file=file, bytes=nbytes, seconds=seconds)


def test_card_time_is_all_busy_time_over_all_bytes():
    g = 1 << 30
    run = make_run([call("enc", "plain", g // 2, 0.5), call("dec", "plain", g // 2, 1.0),
                    call("enc", "plain", g // 2, 1.5), call("dec", "plain", g // 2, 1.0)], n_cards=2)
    assert readers.card_ms_per_gib(run) is None  # no busy time read
    run.card_busy_ns = {0: 300_000_000, 1: 100_000_000}
    assert readers.card_ms_per_gib(run) == pytest.approx(400.0)
    assert readers.card_ms_per_gib(make_run([])) is None


def test_card_busy_is_the_union_of_each_cards_ops():
    E = trace.Event
    evs = [E("k", 0, 10, 30, 1), E("c", 0, 20, 50, 2), E("k", 0, 70, 80, 3),
           E("k", 1, 5, 6, 4), E("cudaLaunchKernel", None, 0, 100, 1)]
    assert trace.card_busy_ns(evs) == {0: 50, 1: 1}
    assert trace.card_busy_ns([]) == {}


def test_union_and_gaps():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36]], dtype=np.int64)
    assert trace._union_ns(iv, 0, 100) == 30
    assert trace._union_ns(iv, 8, 32) == 14
    assert trace._gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert trace.op_name("void (anonymous namespace)::encode_kernel<true>(int const*, int)") \
        == "encode_kernel<true>"
    assert trace.op_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"


def synthetic_trace():
    calls = [trace.Call("enc", "plain", 0, 100), trace.Call("dec", "plain", 100, 300),
             trace.Call("enc", "timed", 300, 400)]
    return trace.Trace(
        calls=calls, cards=[0], window_ns=400, busy_ns={0: 150},
        call_ops=[{"encode_kernel<true>": 20,
                   "model_values_kernel": 10,
                   "crc32_kernel": 5,
                   "Memcpy HtoD (Pinned -> Device)": 8},
                  {"decode_kernel<true>": 30, "Memcpy DtoH (Device -> Pinned)": 4}, {}],
        idle_by_phase={"enc pass2": 40})


def test_copies_and_roofline():
    tr = synthetic_trace()
    g = 1 << 30
    run = make_run([call("enc", "plain", g, 1), call("dec", "plain", g // 2, 1),
                    call("enc", "timed", g, 1)], tr)
    assert readers.copies_ms_per_gib(run, "enc") == pytest.approx(8e-6)
    assert readers.copies_ms_per_gib(run, "dec") == pytest.approx(8e-6)
    assert readers.copies_ms_per_gib(make_run(run.calls), "enc") is None  # untraced
    w = work.ArchiveWork(n=1000, payload=600, coded_payload=500, coded_symbols=900)
    run.work = {0: w}
    run.calls = [call("enc", "plain", 1000, 1), call("dec", "plain", 1000, 1),
                 call("enc", "timed", 1000, 1)]
    assert trace.op_seconds(tr, "enc", work.ENC_CODER) == pytest.approx(30e-9)
    assert readers.roofline_pct(run, "enc", work.ENC_CODER, work.enc_coder) == pytest.approx(
        100 * work.enc_coder(w) / 30e-9)
    assert readers.roofline_pct(run, "enc", r"nothing", work.enc_coder) is None
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["dec decode_kernel<true>", 30e-9]
    assert b["idle_gaps"] == [["enc pass2", 40e-9]]


def test_least_time():
    w = work.ArchiveWork(n=1 << 30, payload=1 << 29, coded_payload=1 << 29, coded_symbols=1 << 30)
    ops = work.ENC_OPS_PER_SYMBOL * (1 << 30) / (64 * 132 * 1.98e9)
    assert work.enc_coder(w) == pytest.approx(ops)  # bound by operations
    assert work.enc_staging(w) == pytest.approx(1.5 * (1 << 30) / 3.35e12)  # by bytes


def test_archive_work():
    from redux_tpu_torch import api
    from benchmark import gen
    data = gen.content("mixed", 9000, 2, "cpu") + gen.content("incompressible", 4096, 3, "cpu")
    arch = api.encode(data, device="cpu")
    w = work.archive_work(arch)
    assert w.n == len(data) and w.payload == len(arch) - (32 + 4 * 4 + 512)
    # blocks of 4096: two of text coded, one of text and random bytes and
    # the 808-byte tail of random bytes stored raw
    assert w.coded_symbols == 8192 and w.payload - w.coded_payload == 4096 + 808


def test_reduce_attributes_ops_to_their_launch():
    E = trace.Event
    evs = [
        E("enc.plain", None, 0, 100, 0), E("dec.timed", None, 100, 300, 0),
        E("cudaLaunchKernel", None, 90, 92, 1), E("encode_kernel<true>(int)", 0, 85, 105, 1),
        E("cudaMemcpyAsync", None, 120, 121, 2),
        E("Memcpy HtoD (Pinned -> Device)", 0, 130, 150, 2),
        E("cudaStreamSynchronize", None, 160, 170, 0), E("cudaStreamSynchronize", None, 50, 55, 0),
        E("mark:upload", None, 200, 200, 0), E("mark:kernels", None, 280, 280, 0),
        E("mark:crc+fetch", None, 290, 290, 0), E("mark:crc+fetch copy", None, 290, 290, 0),
    ]
    tr = trace.reduce(evs)
    assert [(c.kind, c.mode) for c in tr.calls] == [("enc", "plain"), ("dec", "timed")]
    # The device clock trails the host's by 5 ns: the kernel runs 90-110.
    assert tr.call_ops[0] == {"encode_kernel<true>": 20}
    assert tr.call_ops[1] == {"Memcpy HtoD (Pinned -> Device)": 20}
    assert tr.window_ns == 300 and tr.busy_ns == {0: 40}
    # The timed call's gaps, 110-135 and 155-300, cut at its marks: up to
    # 200 "upload", to 280 "kernels", to 290 "crc+fetch copy", then "return".
    assert tr.idle_by_phase == {"dec upload": 70, "dec kernels": 80, "dec crc+fetch copy": 10,
                                "dec return": 10}
