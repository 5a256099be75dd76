"""Mean host milliseconds of the host span's ticks that admitted nothing
and decoded (Server.decode -> transformer.decode_step)."""


def read(run):
    rows = run.decode_rows()
    ms = [(run.t1[i] - run.t0[i]) * 1e3 for i in run.host_ticks
          if run.admits[i] == 0 and rows[i] > 0]
    return sum(ms) / len(ms) if ms else None
