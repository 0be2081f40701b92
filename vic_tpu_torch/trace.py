"""The program's own measurement: host spans on the profiler's clock and
one registry of counters.

Spans. `span(name)` is a context around a piece of the program. While a
torch profiler records, it opens a function-scope record
(`torch._C._profiler._RecordFunctionFast`): a host event on the profiler's
clock, the clock of its device operations, whose parent is the span
around it on the same thread. Such a record is not mirrored onto the
device's timeline (a `record_function` span, user scope, is). With no
profiler recording, `span` reads one flag and returns a shared no-op
context. `phases()` opens spans one after another inside one piece of code:
`ph(name)` closes the phase it has open and opens `name` (None: none), and
leaving its context closes the last. The names the program opens:

    vic.step                    each call of model.make_step's step
    vic.step.<phase>            the step's physics phases, in its order:
                                forcing, soil_thermal, blowing,
                                close_energy (its passes
                                vic.step.close_energy.pass), soil_nodes,
                                runoff, lake, water_balance, outputs
    vic.step.column             each column() pass, with its phases
                                canopy_snow, snow, glacier, snow, surface
    vic.kernel.<name>           each call of a kernel wrapper
                                (vic_tpu_torch.kernels), <name> its key in
                                `launches`
    vic.driver.<stage>          driver.run_simulation's stages (params,
                                forcing, run, write), each cell block
                                (block), the outputs' stack and copy to
                                the host (copy)

Counters. Host counters are plain integers, always on: `launches` (the
calls of each kernel wrapper that reached the device, kept as
kernels.launches), `records` (step calls) and `close_energy_passes`.
Device counters are added by the kernels themselves, with an atomicAdd in
the thread that writes the call's own counts, into an int64 buffer a
device (`device_counter`): K7's Brent trips, profile solves and the sweeps
of all of them (`k7_trips`, `k7_solves`, `k7_sweeps`), and the sweeps of
K6's own launches (`k6_sweeps`); a split block's shares each count their
launch. `counters()` reads all of them, waiting for each device once.
Readers: `records` and `k7_sweeps` feed the benchmark's
k7_sweeps_per_record, `k7_solves` and `k7_sweeps` chip_smoke's K7 line,
and tools/profile_torch_light.py prints every counter's change a record.
"""
from __future__ import annotations

import functools
import threading

import torch
import torch.autograd.profiler as _profiler

_Record = torch._C._profiler._RecordFunctionFast


class _Off:
    """The no-op span and phase cursor."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name):
        pass


_OFF = _Off()


def span(name: str):
    """A span named `name`: a function-scope record while a torch profiler
    records, else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _Record(name)
    return _OFF


class _Phases:
    """Spans opened one after another (see the module's docstring)."""
    __slots__ = ("_open",)

    def __init__(self):
        self._open = None

    def __enter__(self):
        return self

    def __call__(self, name):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            rec = _Record(name)
            rec.__enter__()
            self._open = rec

    def __exit__(self, *exc):
        self(None)
        return False


def phases():
    """A phase cursor: a context whose calls open the next phase."""
    if _profiler._is_profiler_enabled:
        return _Phases()
    return _OFF


# ---- counters ----
_lock = threading.Lock()
# launches of each kernel since the last reset_launches(): calls of its
# wrapper that reached the device (K6's and K7's calls are one cooperative
# launch each, every sweep and, in K7, the whole Brent solve inside it);
# a key for each wrapper made with `kernel`
launches = {}
_host = {"records": 0, "close_energy_passes": 0}
# the device counters, in the order of their slots in a device's buffer
DEVICE_COUNTERS = ("k7_trips", "k7_solves", "k7_sweeps", "k6_sweeps")
_device_totals = {}


def count(name: str, n: int = 1):
    """Adds n to the host counter `name`."""
    with _lock:
        _host[name] += n


def count_launch(name: str):
    with _lock:
        launches[name] += 1


def reset_launches():
    with _lock:
        for k in launches:
            launches[k] = 0


def kernel(name: str):
    """Decorates the kernel wrapper `name`: its launch counter, and a
    vic.kernel.<name> span around each call."""
    launches[name] = 0
    label = "vic.kernel." + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _profiler._is_profiler_enabled:
                with _Record(label):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def device_counter(device, name: str) -> int:
    """The device address of the int64 counter `name` (DEVICE_COUNTERS) on
    `device`, a slot of one zeroed buffer made at its first use, which a
    kernel adds to; consecutive names are consecutive slots."""
    buf = _device_totals.get(device)
    if buf is None:
        with _lock:
            buf = _device_totals.get(device)
            if buf is None:
                buf = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64,
                                  device=device)
                # zeroed before a kernel on any stream adds to it
                torch.cuda.synchronize(device)
                _device_totals[device] = buf
    return buf.data_ptr() + 8 * DEVICE_COUNTERS.index(name)


def counters() -> dict:
    """Every counter as a plain int: the host counters, the device counters
    summed over the devices (after waiting for each device's work), and
    each kernel's launches as launches.<name>."""
    with _lock:
        out = dict(_host)
        out.update({f"launches.{k}": v for k, v in launches.items()})
        bufs = list(_device_totals.items())
    totals = [0] * len(DEVICE_COUNTERS)
    for device, buf in bufs:
        torch.cuda.synchronize(device)
        for i, v in enumerate(buf.tolist()):
            totals[i] += v
    out.update(zip(DEVICE_COUNTERS, totals))
    return out
