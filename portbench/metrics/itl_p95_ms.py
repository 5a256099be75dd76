"""95th percentile of all gaps between consecutive output tokens of every
request, both tokens in the window."""

from portbench import stats


def read(run):
    return stats.percentile(stats.itls_ms(run), 95)
