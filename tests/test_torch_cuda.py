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
    assert all(n > 0 for n in redux_tpu_torch.launch_counts().values())


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda_device):
    from redux_tpu_torch.ops.model import model_lohi
    from redux_tpu_torch.params import Parameters

    syms = torch.zeros(2, 8, dtype=torch.uint8, device=cuda_device)
    lens = torch.full((2,), 8, dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        model_lohi(syms, lens, torch.arange(258, dtype=torch.int32, device=cuda_device),
                   Parameters.tpu_wide(), 16)
