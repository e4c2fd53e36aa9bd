"""The four-card deployment (``rxt-wide22-4card``) held to the benchmark's
plain reference, on the CPU.

A list of four entries (``["cpu"] * 4``) with the lane chunks cut to 8 or
16 blocks of 4096 bytes, so each input takes two full steps of four shares
and an uneven last step, as the cell's 2 GiB take two full steps on four
cards.  The list's archive equals ``benchmark.reference``'s archive for
the configuration byte for byte (the archive does not depend on the
devices), and ``api.decode`` over the list returns the input.  The inputs
are the cell's content kind, ``mixed``, made from seeds: the larger one
holds an incompressible stretch (blocks stored raw), the smaller ends in
a short block.
"""

import pytest
import torch

from benchmark import gen, reference, run
from redux_tpu_torch import api, container

# name -> (bytes, seed, blocks a lane chunk)
INPUTS = {"raw_stretch": (600 << 10, 2**31 + 7, 16), "short_last_block": ((74 << 12) + 123, 11, 8)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as in ``tests/test_torch_dp_route.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_four_entries_write_the_references_archive(monkeypatch, name):
    nbytes, seed, chunk = INPUTS[name]
    config = run.Manifest().config("rxt-wide22-4card")
    assert config["cards"] == 4
    monkeypatch.setattr(api, "ENC_CHUNK_BYTES", chunk * 4096)
    monkeypatch.setattr(api, "DEC_CHUNK_BYTES", chunk * 4096)
    data = gen.content("mixed", nbytes, seed, "cpu")
    devices = ["cpu"] * config["cards"]
    arch = api.encode(data, device=devices, **run.codec_kwargs(config))
    header = container.parse_table(arch)
    steps = api._shares(header.n_blocks, chunk, len(devices))
    assert [len(step) for step in steps] == [4, 4, 4]
    assert len({sh.s1 - sh.s0 for sh in steps[-1]}) == 2
    assert (int(header.raw.sum()) > 0) == (name == "raw_stretch")
    assert arch == reference.archives([data], reference.Config(config))[0]
    assert api.decode(arch, device=devices) == data
