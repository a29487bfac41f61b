"""The program's spans and counters, recorded through `torch.profiler`.

Tracing is on while a `torch.profiler` profile records (the CLI's
`--profile`, a benchmark's traced window) and off otherwise; it has no
switch of its own.

- `span(name)`: a context manager. Off, it is one shared object that does
  nothing, returned after one flag check. On, it is
  `torch.profiler.record_function(name)`: the profile writes the span into
  its trace as a `user_annotation`, on the clock of the device's activity.
- `count(name, n=1)`: host counters, added to only while a profile records;
  `counters()` reads them.

A replay of a captured CUDA graph runs no Python, so spans inside a
captured step are recorded at its eager warm-up and capture only.
"""

import torch
import torch.autograd.profiler as _profiler

_counters = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_OFF = _Off()


def span(name):
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name, n=1):
    if _profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def counters():
    return dict(_counters)
