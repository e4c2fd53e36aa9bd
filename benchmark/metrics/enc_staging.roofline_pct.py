"""The encode staging (S2, S3, bincount) kernels' share of their roofline
in the plain encode calls, %."""

from benchmark import work
from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "enc", work.ENC_STAGING, work.enc_staging)
