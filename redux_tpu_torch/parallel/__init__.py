"""Data parallelism over GPUs: the blocks split across devices, one
launch a device, no collectives (counterpart: ``redux_tpu/parallel``)."""

from .mesh import (
    data_parallel_mesh,
    decode_blocks_sharded,
    encode_blocks_m_sharded,
    encode_blocks_ranked_sharded,
    lane_quantum,
    pad_to_devices,
)

__all__ = [
    "data_parallel_mesh",
    "decode_blocks_sharded",
    "encode_blocks_m_sharded",
    "encode_blocks_ranked_sharded",
    "lane_quantum",
    "pad_to_devices",
]
