"""Data parallelism over devices: the blocks (lanes) split across them.

Counterpart: ``redux_tpu/parallel/mesh.py`` — ``data_parallel_mesh``
(:34-39), ``pad_to_devices`` (:42-45), ``encode_blocks_sharded`` (:74-80),
``initialize_multihost`` (:100-111), ``pallas_lane_quantum`` (:127-144)
and the sharded kernel entries ``encode_blocks_pallas_m_sharded``
(:167-196), ``decode_blocks_pallas_sharded`` (:221-248) and
``encode_blocks_ranked_sharded`` (:270-295).

Blocks are independent streams, so the codec shards along the block axis
with no collectives: the lanes are padded to a multiple of the device
count, cut into contiguous equal shards (what ``P("dp")`` does), each
shard is moved to its device and its kernels are launched there, on that
device's current stream.  Every shard is launched before any is fetched,
so the devices run at once; the results come back to the input's device
in block order.  These entries keep the reference's contracts (the
tests, ``multihost`` and the sharded K5 use them); ``api.encode`` /
``decode`` over a device list do not call them: there each device
uploads, codes and fetches its own shares (``api._shares``), so no byte
goes from device to device.  A "mesh" here is a plain list of
``torch.device``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.decode import decode_blocks
from ..ops.encode import encode_blocks, encode_blocks_ranked
from ..ops.encode_m import encode_blocks_m
from ..params import Parameters

Mesh = list[torch.device]


def data_parallel_mesh(devices: Optional[Sequence] = None, n: Optional[int] = None) -> Mesh:
    """The devices to shard over: ``devices`` (default: every visible CUDA
    device), the first ``n`` of them if ``n`` is given."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n is not None:
        devs = devs[:n]
    if not devs:
        raise ValueError("a data-parallel mesh needs at least one device")
    return devs


def pad_to_devices(b: int, mesh: Mesh) -> int:
    """Round a lane count up to a multiple of the mesh size."""
    n = len(mesh)
    return ((max(b, 1) + n - 1) // n) * n


def lane_quantum(mesh: Mesh) -> int:
    """Lane alignment of a sharded call: the device count (the CUDA kernels
    take any lane count, so no tile width enters)."""
    return len(mesh)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pad_lanes(x: torch.Tensor, b_pad: int, fill: int) -> torch.Tensor:
    if x.shape[0] == b_pad:
        return x
    pad = x.new_full((b_pad - x.shape[0], *x.shape[1:]), fill)
    return torch.cat([x, pad])


def _sharded(fn: Callable, mesh: Mesh, lanes: Sequence[tuple], replicated: Sequence):
    """Run ``fn(*lane_shards, *replicated)`` on every device of ``mesh``.

    ``lanes`` holds ``(tensor, pad fill)`` pairs with the lanes on axis 0;
    ``replicated`` goes whole to every device.  Returns ``fn``'s outputs,
    each gathered in lane order onto the first lane tensor's device.
    """
    home = lanes[0][0].device
    b = lanes[0][0].shape[0]
    b_pad = pad_to_devices(b, mesh)
    per = b_pad // len(mesh)
    padded = [_pad_lanes(x, b_pad, fill) for x, fill in lanes]
    results = []
    for i, dev in enumerate(mesh):
        with _on(dev):
            shard = [x[i * per : (i + 1) * per].to(dev).contiguous() for x in padded]
            out = fn(*shard, *[r.to(dev) for r in replicated])
        results.append(out if isinstance(out, tuple) else (out,))
    gathered = tuple(torch.cat([r[j].to(home) for r in results])[:b]
                     for j in range(len(results[0])))
    return gathered if len(gathered) > 1 else gathered[0]


def encode_blocks_sharded(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor,
                          init_total: int, params: Parameters, n_words: int, mesh: Mesh,
                          delta: int = 1):
    """Sharded K2 over given model values: the counterpart of the
    reference's ``encode_blocks_sharded`` (:74-80), which shards its XLA v2
    coder over ``(lo, hi, tot)``.  K2 computes that ``tot`` plane in closed
    form (``redux_tpu/ops/ranks.py:216-218``) from ``init_total`` and
    ``delta``, so it takes no plane.  Contract of
    :func:`redux_tpu_torch.ops.encode.encode_blocks`; any lane count."""
    return _sharded(
        lambda lo_s, hi_s, lens_s: encode_blocks(lo_s, hi_s, lens_s, init_total, params,
                                                 n_words, delta),
        mesh, [(lo, 0), (hi, 0), (lens, -1)], [])


def initialize_multihost(coordinator: str, world_size: int, rank: int, backend: str) -> None:
    """Join the process group of a multi-host job: the counterpart of the
    reference's ``initialize_multihost`` (:100-111), on
    ``torch.distributed``.

    ``coordinator`` is ``host:port`` of rank 0; ``backend`` is ``"gloo"``
    or ``"nccl"``, never chosen here.  A no-op when the group exists.  A
    failed rendezvous raises (the reference swallows every RuntimeError,
    which hides that too).  Each process then shards its own blocks over
    its local devices; the blocks need no collective until the gather.
    """
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank)


def encode_blocks_ranked_sharded(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                                 params: Parameters, n_words: int, mesh: Mesh, delta: int = 1):
    """Sharded :func:`redux_tpu_torch.ops.encode.encode_blocks_ranked` (K1 -> K2,
    or K4 under ``REDUX_TPU_ENC_FUSED``, inside each shard).  Same
    contract; any lane count."""
    return _sharded(
        lambda s, l, ic: encode_blocks_ranked(s, l, ic, params, n_words, delta),
        mesh, [(syms, 0), (lens, -1)], [init_cum])


def encode_blocks_m_sharded(syms: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                            params: Parameters, n_words: int, mesh: Mesh, delta: int = 1):
    """Sharded :func:`redux_tpu_torch.ops.encode_m.encode_blocks_m` (K5).
    Same contract; any lane count."""
    return _sharded(
        lambda s, l, ic: encode_blocks_m(s, l, ic, params, n_words, delta),
        mesh, [(syms, 0), (lens, -1)], [init_cum])


def decode_blocks_sharded(words: torch.Tensor, lens: torch.Tensor, init_cum: torch.Tensor,
                          params: Parameters, k: int, mesh: Mesh, delta: int = 1):
    """Sharded :func:`redux_tpu_torch.ops.decode.decode_blocks` (K3), the
    counterpart of ``decode_blocks_pallas_sharded``.  Same contract; any
    lane count."""
    return _sharded(
        lambda w, l, ic: decode_blocks(w, l, ic, params, k, delta),
        mesh, [(words, 0), (lens, 0)], [init_cum])
