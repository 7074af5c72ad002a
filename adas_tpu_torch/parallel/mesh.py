"""The (data, model) device mesh (port of ``adas_tpu/parallel/mesh.py``).

Axes, as in JAX:

* ``data``: independent video streams, or the training batch (pure data
  parallelism; trackers and analytics stay on the host, per stream);
* ``model``: tensor-parallel shards of the UFLD MLP head
  (``parallel/sharding.py``).

JAX drives every device of a mesh from one process, and so does the port:
a :class:`Mesh` is a 2-D array of ``torch.device`` with the axis names,
and the code that runs on it keeps one replica of a net per data row,
splits the batch on the host and issues each row's work under that row's
device.  Serving issues the rows in turn from the calling thread
(:func:`in_turn`).  Issuing a row's step costs the host about as much
as issuing the whole unsharded step, so an eager tick on a mesh is host
bound and slower than on one card, and more so as rows are added (the
YOLOv8l + UFLDv2 int8 tick's step on four H100s at 700 W: 80.2 ms on a
(4, 1) mesh against 13.8 ms unsharded on one of them; ``PERF.md``).
Only a replay of a CUDA graph per row (``MultiStreamADAS``'s compute
probe) lets the cards work at once.  A thread per row was slower still:
the host's part of a launch holds the interpreter lock.  The trainer's
rows run on threads of their own (:class:`RowThreads`), since each of
its BatchNorms waits for the other rows' statistics.  A mesh may name
one device more than once (``Mesh([["cuda:0"], ["cuda:0"]])``): the rows
then share that device, each with its own replica, the way JAX's CPU
tests run 8 virtual devices on one host.  Cross-device sums (:func:`sum_to`) are copies to
one device and adds in row order, whether the devices are distinct cards
or one device repeated, so both give the same values.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "model")


def _device(d) -> torch.device:
    """``d`` as a torch.device that exists: a CUDA device on a machine
    without one, or past the cards present, raises (no CPU fallback)."""
    from ..perception.object_detector import resolve_device

    dev = resolve_device(d)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise ValueError(f"{d!r} names a card past the {torch.cuda.device_count()} present")
        dev = torch.device("cuda", index)
    return dev


class Mesh:
    """A 2-D grid of devices with axis names (``jax.sharding.Mesh``):
    ``devices`` (an object array of ``torch.device``), ``shape`` (axis name
    -> size), ``size`` (cells, repeats counted) and ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, got shape {grid.shape}")
        if len(axis_names) != 2 or len(set(axis_names)) != 2:
            raise ValueError(f"a mesh has two distinct axis names, got {tuple(axis_names)}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = _device(d)
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def repeats(self) -> bool:
        """Whether a device appears in more than one cell."""
        return len(set(self.devices.flat)) < self.size

    def axis_size(self, name: str) -> int:
        return self.devices.shape[self.axis_names.index(name)]

    def row_devices(self) -> List[torch.device]:
        """The device of each data row's replica: the row's first cell."""
        return list(self.devices[:, 0])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat)))

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(map(str, self.devices.flat)), self.devices.shape))

    def __repr__(self) -> str:
        rows = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({rows}, axis_names={self.axis_names})"


def mesh_shape(n_devices: int, model_parallel: Optional[int] = None,
               available: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) of :func:`make_mesh` over ``n_devices`` (``mesh.py:21-49``):
    ``model_parallel`` defaults to 2 when the count is even and above 1,
    else 1; more devices than ``available`` raise, as does a
    ``model_parallel`` that does not divide the count."""
    if available is not None and n_devices > available:
        raise ValueError(f"requested {n_devices} devices, only {available} present")
    if model_parallel is None:
        model_parallel = 2 if (n_devices % 2 == 0 and n_devices > 1) else 1
    if n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n_devices}")
    return n_devices // model_parallel, model_parallel


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: Optional[int] = None,
    axis_names: Sequence[str] = AXES,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA card, ``cuda:0..n-1``), shaped by
    :func:`mesh_shape`.  Without a card and without ``devices`` it raises,
    as the facades do; ``devices=["cpu"] * 8`` gives a CPU mesh that
    repeats one device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh over CUDA devices requested but no CUDA GPU is available")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    rows, cols = mesh_shape(n_devices, model_parallel, available=len(devices))
    return Mesh(np.asarray(devices[:n_devices], dtype=object).reshape(rows, cols), axis_names)


def device_scope(device: torch.device):
    """The current-device context of ``device`` (a no-op off CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def sum_to(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, each copied there
    first, added in order: the one cross-device sum of the mesh code, for
    distinct cards and a repeated device alike (a copy to the device a
    tensor is on is the tensor itself)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def in_turn(devices: Sequence[torch.device], fn: Callable, *per_row: Sequence) -> list:
    """``fn(r, *args[r])`` for every data row ``r`` in order, under the
    row's current device, from the calling thread; the results in row
    order."""
    out = []
    for r, dev in enumerate(devices):
        with device_scope(dev):
            out.append(fn(r, *(a[r] for a in per_row)))
    return out


class RowThreads:
    """One thread per data row, for work whose rows wait on one another
    (the trainer's BatchNorm statistics): :meth:`run` calls
    ``fn(r, *args[r])`` for every row on row ``r``'s thread, under that
    row's current device, and returns the results in row order; the first
    exception of a row is raised after every row has finished.  A single
    row runs on the caller's thread.  Each row thread takes the creating
    thread's intra-op thread count: a new thread's OpenMP default (every
    core) would split the CPU operators' work otherwise, and round them
    otherwise, than the caller's."""

    def __init__(self, devices: Sequence[torch.device], name: str = "adas-row"):
        self.devices = list(devices)
        self._name = name
        self._pools: Optional[List[ThreadPoolExecutor]] = None

    def _call(self, fn: Callable, r: int, args):
        with device_scope(self.devices[r]):
            return fn(r, *args)

    def run(self, fn: Callable, *per_row: Sequence) -> list:
        n = len(self.devices)
        rows = [tuple(a[r] for a in per_row) for r in range(n)]
        if n == 1:
            return [self._call(fn, 0, rows[0])]
        if self._pools is None:
            threads = torch.get_num_threads()
            self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"{self._name}{r}",
                                              initializer=torch.set_num_threads,
                                              initargs=(threads,))
                           for r in range(n)]
        futures = [pool.submit(self._call, fn, r, rows[r]) for r, pool in enumerate(self._pools)]
        errors = [e for e in (f.exception() for f in futures) if e is not None]
        # a row that failed breaks the others' rendezvous: raise its error
        errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        if errors:
            raise errors[0]
        return [f.result() for f in futures]

    def close(self) -> None:
        for pool in self._pools or ():
            pool.shutdown(wait=True)
        self._pools = None
