"""Spans and counters of the serving path, on the profiler's clock.

``span(NAME)`` opens a host range named ``NAME`` (one of the ``repro_torch.*``
constants below) while a ``torch.profiler`` session records the host's
activity. Kineto writes the range into the same trace as the card's kernels
and copies, on the same clock, so each stretch in which the card idles can be
put down to the innermost range open during it. Otherwise ``span`` returns one
shared no-op context: with no profiler running, a span costs one C call and a
``with`` on a null object.

``count(NAME, value)`` adds ``value`` into the counter set under the same
gate: a host int, or a device tensor, which is added on the device and never
read there. ``counters()`` reads the set to host numbers; that read is its one
synchronisation. Each session that records the host starts a fresh set, so a
set covers one profiled stretch.

Which sessions record the host: ``_profiler_enabled()`` is true under a
session of the card alone too, and torch keeps a running session's
activities nowhere that can be asked. So this module wraps
``torch.autograd.profiler._enable_profiler``, through which every
``torch.profiler.profile`` and ``torch.autograd.profiler.profile`` session
starts, and notes whether the session's activities include the CPU. Under a
session started any other way, the ranges open whenever a profiler runs.

Spans (nested as listed; the same names on the ESP, EP and mesh paths):

* ``RequestScheduler.step``: ``sched.faults``, ``sched.admit`` (one an
  admission: ``server.prefill``, ``sched.admit_read``), ``sched.headroom``,
  ``sched.drain``, ``sched.decode`` (``Server.decode``), ``sched.sample``
  (``sched.logits_read``, the logits' fp32 cast and copy to the host, where
  the host waits for the card; ``sched.argmax``);
* ``Server.decode``: ``balance.drain`` (``balance.slice``, one a migration
  slice), ``server.step`` (``decode_step``), ``balance.observe``
  (``balance.read``, the expert counts' copy to the host);
* ``decode_step`` and ``prefill``, each layer: ``model.attention``,
  ``model.moe`` (``model.mlp`` for a dense FFN); once a step
  ``model.logits``;
* the MoE layer: ``moe.route``, ``moe.dispatch``, ``moe.ffn``,
  ``moe.combine``; on the mesh ``moe.all_to_all`` around each exchange.

Counters: ``admit.real_tokens`` and ``admit.bucket_tokens``, the true and the
padded length of each splice admission; on the EP path's decode calls
``moe.decode_calls``, ``moe.ep_devices`` (the EP devices of each call, virtual
ones on one process), ``moe.max_device_rows`` (each call's largest device's
kept rows) and ``moe.routed_rows`` (each call's kept rows), computed from each
call's kept rows per slot when ``counters()`` reads the set.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

SCHED_FAULTS = "repro_torch.sched.faults"
SCHED_ADMIT = "repro_torch.sched.admit"
SCHED_ADMIT_READ = "repro_torch.sched.admit_read"
SCHED_HEADROOM = "repro_torch.sched.headroom"
SCHED_DRAIN = "repro_torch.sched.drain"
SCHED_DECODE = "repro_torch.sched.decode"
SCHED_SAMPLE = "repro_torch.sched.sample"
SCHED_LOGITS_READ = "repro_torch.sched.logits_read"
SCHED_ARGMAX = "repro_torch.sched.argmax"
SERVER_PREFILL = "repro_torch.server.prefill"
SERVER_STEP = "repro_torch.server.step"
BALANCE_DRAIN = "repro_torch.balance.drain"
BALANCE_SLICE = "repro_torch.balance.slice"
BALANCE_OBSERVE = "repro_torch.balance.observe"
BALANCE_READ = "repro_torch.balance.read"
MODEL_ATTENTION = "repro_torch.model.attention"
MODEL_MOE = "repro_torch.model.moe"
MODEL_MLP = "repro_torch.model.mlp"
MODEL_LOGITS = "repro_torch.model.logits"
MOE_ROUTE = "repro_torch.moe.route"
MOE_DISPATCH = "repro_torch.moe.dispatch"
MOE_FFN = "repro_torch.moe.ffn"
MOE_COMBINE = "repro_torch.moe.combine"
MOE_ALL_TO_ALL = "repro_torch.moe.all_to_all"

ADMIT_REAL_TOKENS = "admit.real_tokens"
ADMIT_BUCKET_TOKENS = "admit.bucket_tokens"
MOE_DECODE_CALLS = "moe.decode_calls"
MOE_EP_DEVICES = "moe.ep_devices"
MOE_MAX_DEVICE_ROWS = "moe.max_device_rows"
MOE_ROUTED_ROWS = "moe.routed_rows"

_enabled = torch._C._autograd._profiler_enabled
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit

_host = True        # does the running session record the host?
_counts: dict = {}
_ep_rows: list = []  # (kept rows per slot, EP devices) of each EP decode call


NULL = contextlib.nullcontext()


class _Range:
    """One host range: the RecordFunction pair ``record_function`` opens,
    without its dispatcher round trip."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _enter(self.name)

    def __exit__(self, *exc):
        _exit(self.handle)
        return False


def span(name: str):
    """A range ``name`` while the host is recorded, else ``NULL``."""
    if _host and _enabled():
        return _Range(name)
    return NULL


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a device tensor kept on the device) into
    counter ``name`` while the host is recorded."""
    if not (_host and _enabled()):
        return
    cur = _counts.get(name)
    _counts[name] = value if cur is None else cur + value


def count_ep_rows(slot_rows: torch.Tensor, n_devices: int) -> None:
    """One EP decode call's kept rows per slot, the slots laid out device
    after device. The tensor is kept as it is and becomes the ``moe.*``
    counters when ``counters()`` reads the set, so the call launches
    nothing."""
    if not (_host and _enabled()):
        return
    _ep_rows.append((slot_rows, n_devices))


def counters() -> dict:
    """The current set as host numbers (device counters read here)."""
    out = {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in _counts.items()}
    if _ep_rows:
        calls = defaultdict(list)
        for rows, n in _ep_rows:
            calls[(rows.numel(), n)].append(rows)
        top = routed = 0
        for (_, n), rows in calls.items():
            per_device = torch.stack(rows).reshape(len(rows), n, -1).sum(dim=2)
            top += int(per_device.max(dim=1).values.sum())
            routed += int(per_device.sum())
        out.update({MOE_DECODE_CALLS: len(_ep_rows),
                    MOE_EP_DEVICES: sum(n for _, n in _ep_rows),
                    MOE_MAX_DEVICE_ROWS: top, MOE_ROUTED_ROWS: routed})
    return out


def _session_start(enable):
    def enable_profiler(config, activities, *args, **kwargs):
        global _host
        _host = _profiler.ProfilerActivity.CPU in activities
        if _host:
            _counts.clear()
            _ep_rows.clear()
        return enable(config, activities, *args, **kwargs)

    enable_profiler.repro_torch_tracing = True
    return enable_profiler


if not getattr(_profiler._enable_profiler, "repro_torch_tracing", False):
    _profiler._enable_profiler = _session_start(_profiler._enable_profiler)
