"""The port's kernels as PyTorch operators, in the namespace
``adas_tpu_torch``.

Each kernel is one operator with a CPU implementation (its plain
version), a CUDA one (its launch) and a fake one (the output's shape and
dtype), so that ``torch.export`` keeps each call as one graph node and an
exported program launches the kernels as the eager path does.

The operators are defined through ``torch.library.Library`` (``define`` /
``impl``), not ``torch.library.custom_op``: the latter wraps every call in
Python layers of its own (an autograd function and a device dispatch), a
host cost per call that the batch-1 paths, which make ~160 kernel calls
a frame and are host bound, pay in full (``tools/dispatch_ab.py``
measures both).  Here the dispatcher goes straight from the C++ operator
to the implementation.
"""
from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "adas_tpu_torch"

# kept for the life of the process: the operators go with it
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the operator ``schema`` (``"name(Tensor x, ...) -> Tensor"``)
    with its CPU, CUDA and fake implementations; returns its overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
