"""Median time from submission to the end of the tick that emitted the
first token, over every request whose first token fell in the window."""

from portbench import stats


def read(run):
    return stats.percentile(stats.ttfts_ms(run), 50)
