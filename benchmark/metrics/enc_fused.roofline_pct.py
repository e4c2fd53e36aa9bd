"""The fused encoder (K4, ``encode_fused_kernel``) alone: its share of the
encode coder's roofline in the plain encode calls, %.  None where no K4
ran (a program on the split route K1 -> K2, or one without K4)."""

from benchmark import work
from benchmark.readers import roofline_pct

FUSED = r"\bencode_fused_kernel\b"


def read(run):
    return roofline_pct(run, "enc", FUSED, work.enc_coder)
