"""Data parallelism over GPUs and hosts: the blocks split across devices,
one launch a device, no collectives until the gather (counterpart:
``redux_tpu/parallel``; the multi-host worker is
``python -m redux_tpu_torch.parallel.multihost``)."""

from .mesh import (
    data_parallel_mesh,
    decode_blocks_sharded,
    encode_blocks_m_sharded,
    encode_blocks_ranked_sharded,
    encode_blocks_sharded,
    initialize_multihost,
    lane_quantum,
    pad_to_devices,
)

__all__ = [
    "data_parallel_mesh",
    "decode_blocks_sharded",
    "encode_blocks_m_sharded",
    "encode_blocks_ranked_sharded",
    "encode_blocks_sharded",
    "initialize_multihost",
    "lane_quantum",
    "pad_to_devices",
]
