"""The encode coder (K1, K2) kernels' share of their roofline in the plain encode calls, %."""

from benchmark import work
from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "enc", work.ENC_CODER, work.enc_coder)
