"""Rows the decode step served over the batch, averaged over the host
span's ticks (RequestScheduler)."""


def read(run):
    rows = run.decode_rows()
    ticks = list(run.host_ticks)
    if not ticks:
        return None
    return 100.0 * float(rows[ticks].mean()) / run.batch
