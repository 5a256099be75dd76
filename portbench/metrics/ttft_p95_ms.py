"""95th percentile of the time to first token (see ttft_p50_ms)."""

from portbench import stats


def read(run):
    return stats.percentile(stats.ttfts_ms(run), 95)
