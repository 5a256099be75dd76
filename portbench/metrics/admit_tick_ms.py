"""Mean host milliseconds of the host span's ticks that admitted at least
one request (RequestScheduler._admit_ready -> Server.prefill_into_slot)."""


def read(run):
    ms = [(run.t1[i] - run.t0[i]) * 1e3 for i in run.host_ticks if run.admits[i] > 0]
    return sum(ms) / len(ms) if ms else None
