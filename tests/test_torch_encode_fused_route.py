"""``api.encode``'s ``fused`` argument: K4, the fused model and coder, on
the normal path, on the CPU through the plain versions.

The fused archive equals the split route's (K1 -> K2) and the benchmark's
plain reference archive (``benchmark.reference``, for the configuration
``rxt-wide22-fused``) byte for byte, on one device and on a list of two,
and decodes back to its input.  ``fused=True`` at parameters K4 does not
take raises before any device work; ``fused=False`` runs K1 -> K2 whatever
``REDUX_TPU_ENC_FUSED`` says; not given, the variable picks as before.  A
recorded call counts its blocks by route (``fused_blocks`` /
``split_blocks``).
"""

import pytest
import torch

import redux_tpu_torch.ops.encode as enc
from benchmark import reference, run
from redux_tpu_torch import _build, api
from redux_tpu_torch.errors import InvalidInputError
from redux_tpu_torch.params import Parameters
from redux_tpu_torch.testdata import incompressible, mixed, text_like

KINDS = {"text_like": text_like, "mixed": mixed, "incompressible": incompressible}
SIZES = {"empty": 0, "one": 1, "short": 4095, "block": 4096, "tail": 3 * 4096 + 777}
# Every size of text; the other kinds at the sizes that differ in work.
CASES = [("text_like", size) for size in SIZES] + [
    (kind, size) for kind in ("mixed", "incompressible")
    for size in ("empty", "one", "short", "tail")]
SEED = 2**31 + 25
SMALL = 256  # the block size of the tests of routes alone, which need no reference


def _input(kind: str, size: str) -> bytes:
    return KINDS[kind](SIZES[size], SEED + list(SIZES).index(size))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as in ``tests/test_torch_dp_route.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config():
    cfg = run.Manifest().config("rxt-wide22-fused")
    assert cfg["encode"] == {"fused": True}
    return cfg


@pytest.fixture(scope="module")
def references(config):
    """The reference's archive of every case, coded together."""
    datas = [_input(kind, size) for kind, size in CASES]
    return dict(zip(CASES, reference.archives(datas, reference.Config(config))))


def _fail(*_args, **_kw):
    raise AssertionError("the other route ran")


@pytest.mark.parametrize("kind,size", CASES)
def test_fused_archive_is_the_split_routes_and_the_references(monkeypatch, references, config,
                                                               kind, size):
    data = _input(kind, size)
    kw = run.codec_kwargs(config)
    assert kw.pop("fused") is True
    split = api.encode(data, fused=False, device="cpu", **kw)
    with monkeypatch.context() as m:  # K1 and K2 must not run
        m.setattr(enc, "model_lohi", _fail)
        m.setattr(enc, "encode_blocks", _fail)
        fused = api.encode(data, fused=True, device="cpu", **kw)
    assert fused == split == references[kind, size]
    assert api.decode(fused, device="cpu") == data


def test_fused_over_a_list_of_two_is_the_references(monkeypatch, references, config):
    """Four blocks over ``["cpu", "cpu"]``: a share of two blocks each."""
    data = _input("mixed", "tail")
    with monkeypatch.context() as m:
        m.setattr(enc, "model_lohi", _fail)
        m.setattr(enc, "encode_blocks", _fail)
        arch = api.encode(data, device=["cpu", "cpu"], **run.codec_kwargs(config))
    assert arch == references["mixed", "tail"]
    assert api.decode(arch, device=["cpu", "cpu"]) == data


@pytest.mark.parametrize("params", [Parameters.default(), Parameters(8, 21, 32)],
                         ids=["8-30-32", "8-21-32"])
def test_fused_at_parameters_k4_refuses_raises_before_any_device_work(monkeypatch, params):
    """Raised before the card is looked for (the default device is the
    card, which this machine may lack) and before any upload."""
    assert not (params.fits_u32 or params.fits_wide32)
    monkeypatch.setattr(api, "_Upload", _fail)
    with pytest.raises(InvalidInputError):
        api.encode(b"some bytes" * 500, params=params, fused=True)
    with pytest.raises(ValueError):
        enc.fused_selected(params, True)
    assert enc.fused_selected(params, False) is False


def test_fused_false_runs_the_split_route_under_the_variable(monkeypatch):
    monkeypatch.setenv("REDUX_TPU_ENC_FUSED", "1")
    monkeypatch.setattr(enc, "encode_blocks_fused", _fail)
    data = _input("mixed", "tail")
    arch = api.encode(data, block_size=SMALL, fused=False, device="cpu")
    assert api.decode(arch, device="cpu") == data
    assert enc.fused_selected(Parameters.tpu_wide(), False) is False


@pytest.mark.parametrize("variable,params,route", [
    (None, Parameters.tpu_wide(), "split"), ("0", Parameters.tpu_wide(), "split"),
    ("1", Parameters.tpu_wide(), "fused"), ("1", Parameters.default(), "split")])
def test_not_given_the_variable_picks_as_before(monkeypatch, variable, params, route):
    """The reference's switch, with K1 -> K2 at parameters K4 does not take."""
    if variable is None:
        monkeypatch.delenv("REDUX_TPU_ENC_FUSED", raising=False)
    else:
        monkeypatch.setenv("REDUX_TPU_ENC_FUSED", variable)
    monkeypatch.setattr(enc, "encode_blocks_fused" if route == "split" else "model_lohi", _fail)
    data = _input("text_like", "short")
    arch = api.encode(data, params=params, block_size=SMALL, device="cpu")
    assert api.decode(arch, device="cpu") == data
    assert enc.fused_selected(params) is (route == "fused")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("devs", ["cpu", ["cpu", "cpu"]], ids=["one", "two"])
def test_a_recorded_call_counts_its_blocks_by_route(monkeypatch, fused, devs):
    """Every block of the call, on the route it took, and none on the
    other; ``_build.route_blocks`` keys the CPU's count by ``"cpu"``."""
    monkeypatch.setattr(_build, "route_blocks", type(_build.route_blocks)())
    data = _input("mixed", "short")
    api.encode(data, block_size=SMALL, fused=fused, device=devs, _timings={})
    rec = api.recorded_calls()[-1]
    n_blocks = 16
    want = (n_blocks, 0) if fused else (0, n_blocks)
    assert (rec["fused_blocks"], rec["split_blocks"]) == want
    assert (rec["warp_blocks"], rec["thread_blocks"]) == (0, 0)
    assert dict(_build.route_blocks) == {("fused" if fused else "split", "cpu"): n_blocks}
    arch = api.encode(data, block_size=SMALL, fused=fused, device=devs)
    assert api.decode(arch, device=devs, _timings={}) == data
    rec = api.recorded_calls()[-1]
    assert rec["kind"] == "dec" and (rec["fused_blocks"], rec["split_blocks"]) == (0, 0)
