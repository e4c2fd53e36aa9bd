"""The decode staging (S1, S3) kernels' share of their roofline in the plain decode calls, %."""

from benchmark import work
from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "dec", work.DEC_STAGING, work.dec_staging)
