"""Data parallelism over GPUs and hosts: the sharded kernel entries (the
blocks split across devices, one launch a device, no collectives until
the gather) and the multi-host worker ``python -m
redux_tpu_torch.parallel.multihost`` (counterpart: ``redux_tpu/parallel``).
``api.encode`` / ``decode`` take a device list themselves."""

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
