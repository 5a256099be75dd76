"""Output tokens emitted in the window over the window's seconds."""

from portbench import stats


def read(run):
    return stats.tokens_in_window(run) / (run.t_close - run.t_open)
