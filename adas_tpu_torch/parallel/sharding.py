"""Sharding rules and their placement on a mesh (port of
``adas_tpu/parallel/sharding.py``).

The convolutional trunks are small: they are replicated, one copy per
data row.  Tensor parallelism serves only the UFLD MLP head: ``cls_fc1``
is split by its output features over ``model`` and ``cls_fc2`` by its
input features, so the pair is column shards -> ReLU per shard -> row
shards -> one sum (Megatron's column -> row split; in JAX XLA inserts
that sum).

torch keeps a ``Linear.weight`` as (out, in), the transpose of a flax
``kernel`` (in, out): JAX's ``cls_fc1`` kernel ``P(None, "model")`` is
the port's ``P("model", None)`` (rows of the weight, and the bias), its
``cls_fc2`` ``P("model", None)`` the port's ``P(None, "model")`` (columns;
the bias is replicated).  The int8 head (``models/quant.QLinear``, JAX's
``Int8Dense``) splits its packed ``wq`` by the same rule; its scale
buffers (``wscale``, ``xmax``) are replicated, as JAX replicates every
leaf but the kernels and ``cls_fc1``'s bias.  The int8 pair sums the s32
partial products of ``cls_fc2`` before the dequant, so the sharded head
equals the unsharded one to the bit.

:class:`NamedSharding.index` is the one split of the mesh code: the
head's shards, the scattered leaves and the batch parts are all cut by
it.  :class:`MeshReplicas` is the port's placement of a net on a mesh
(JAX's ``device_put`` of a variables tree with these shardings): per data
row a replica of the net on the row's first device, whose head, when the
``model`` axis is longer than 1, is a :class:`TensorParallelMLP` with its
shards on the row's devices, held as the replica's ``mlp`` (the UFLD
nets run a module of that name in place of the pair).  It gathers whole
leaves (checkpoints) and scatters them back, and sums gradients across
rows (the trainer).
"""
from __future__ import annotations

import copy
import functools
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..models.quant import QLinear, dynamic_scale, per_row, reset_int8_cache, scale_from_max
from ..ops.int8_conv import int_mm, requantize
from .mesh import Mesh, sum_to

#: the head modules that tensor parallelism splits
TP_MODULES = ("cls_fc1", "cls_fc2")


class PartitionSpec(tuple):
    """A mesh axis name (or None: not split) per tensor dimension, as
    ``jax.sharding.PartitionSpec``; dimensions past its length are not
    split."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a :class:`PartitionSpec` (``jax.sharding.NamedSharding``):
    :meth:`index` names the piece of a tensor that each mesh cell holds."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and self.mesh == other.mesh \
            and self.spec == other.spec

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def index(self, shape: Sequence[int], cell) -> tuple:
        """The slices of a tensor of ``shape`` that ``cell`` (row, column)
        holds; an axis must split its dimension evenly."""
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.axis_size(axis)
            if size % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over "
                                 f"{n} devices of {axis!r}")
            i = cell[self.mesh.axis_names.index(axis)]
            out.append(slice(i * size // n, (i + 1) * size // n))
        return tuple(out)


def batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Shard the leading (stream-batch) dim over ``data``, replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_part(mesh: Mesh, x, row: int):
    """Data row ``row``'s part of a batch ``x`` (a tensor or an array) by
    :func:`batch_sharding`: the rows' parts of its leading dim in order."""
    return x[batch_sharding(mesh, x.ndim).index(x.shape, (row, 0))]


def _names(path) -> List[str]:
    if isinstance(path, str):
        return path.split(".")
    return [getattr(k, "key", str(k)) for k in path]


def tp_param_spec(path, leaf: Any = None) -> PartitionSpec:
    """The PartitionSpec of one leaf of the port's module tree, keyed by its
    path (a dotted name such as ``"cls_fc1.weight"``, or its parts):
    ``cls_fc1``'s ``weight``/``wq`` (out, in) split by rows and its bias,
    ``cls_fc2``'s ``weight``/``wq`` split by columns; everything else is
    replicated (``sharding.py:30-44``, transposed as the module doc says)."""
    names = _names(path)
    if "cls_fc1" in names:
        if names[-1] in ("weight", "wq"):
            return P("model", None)
        if names[-1] == "bias":
            return P("model")
    if "cls_fc2" in names and names[-1] in ("weight", "wq"):
        return P(None, "model")
    return P()


def _leaves(variables) -> Dict[str, torch.Tensor]:
    if isinstance(variables, nn.Module):
        return OrderedDict([*variables.named_parameters(), *variables.named_buffers()])
    return OrderedDict(variables)


def param_shardings(variables, mesh: Mesh) -> Dict[str, NamedSharding]:
    """The NamedSharding of every leaf of ``variables`` (a module or a
    mapping of dotted names to tensors) by :func:`tp_param_spec`."""
    return OrderedDict((k, NamedSharding(mesh, tp_param_spec(k))) for k in _leaves(variables))


def replicate(module: nn.Module, device: torch.device, skip: Sequence[str] = ()) -> nn.Module:
    """A copy of ``module`` on ``device``, without its children named in
    ``skip``.  The derived-tensor caches (``models/quant.Int8State``:
    packed kernel weights, BN folds, ``w_bf16``) live in each module's
    ``__dict__``, which ``copy.deepcopy`` copies with the source's device
    tensors: they are dropped, and each replica builds its own on its
    device at its first call."""
    memo = {id(getattr(module, name)): None for name in skip}
    rep = copy.deepcopy(module, memo).to(device)
    for name in skip:
        delattr(rep, name)
    reset_int8_cache(rep)
    return rep


class _Holder(nn.Module):
    """The leaves of a head module (or a shard of them) under the whole
    module's leaf names (``weight``, ``bias``, ``wq``, ``wscale``, ``xmax``)."""


def _as_leaf(t: torch.Tensor, device: torch.device, param: bool):
    t = t.detach().to(device, copy=True).contiguous()
    return nn.Parameter(t, requires_grad=True) if param else t


class TensorParallelMLP(nn.Module):
    """``cls_fc2(relu(cls_fc1(x)))`` split over the devices of data row
    ``row`` of ``mesh`` (the first is the row's replica's), each cell's
    shards cut by :meth:`NamedSharding.index`: the input goes to every
    shard's device, each computes its columns of
    ``cls_fc1`` and their ReLU and its rows' partial product of
    ``cls_fc2``, and the partials are summed on the first device (copies
    and adds in shard order, :func:`mesh.sum_to`), where ``cls_fc2``'s bias
    is added once.  ``fc1``/``fc2`` hold each shard's split leaves, on its
    device; ``rep1``/``rep2`` the replicated ones, on the first device.

    An int8 pair (packed ``QLinear``s, weights as :meth:`QLinear.pack`
    leaves them) quantizes the input once, takes each ``cls_fc1`` shard's
    output features at the whole layer's scales, and sums ``cls_fc2``'s
    s32 partials before one dequant: the unsharded head's arithmetic,
    element for element (a dynamic input scale of ``cls_fc2`` is the max
    of the shards' absmaxes)."""

    def __init__(self, fc1: nn.Linear, fc2: nn.Linear, mesh: Mesh, row: int):
        super().__init__()
        self.devices = list(mesh.devices[row])
        self.int8 = isinstance(fc1, QLinear)
        if self.int8 and (fc1.wq is None or fc2.wq is None):
            raise ValueError("an int8 head splits its packed weights: pack the net first "
                             "(models.quant.pack_int8_weights)")
        n = len(self.devices)
        self.fc1 = nn.ModuleList([_Holder() for _ in range(n)])
        self.fc2 = nn.ModuleList([_Holder() for _ in range(n)])
        self.rep1, self.rep2 = _Holder(), _Holder()
        for name, whole in (("cls_fc1", fc1), ("cls_fc2", fc2)):
            shards, rep = self.holders(name)
            leaves = [(k, t, True) for k, t in whole.named_parameters(recurse=False)]
            leaves += [(k, t, False) for k, t in whole.named_buffers(recurse=False)]
            for leaf, t, param in leaves:
                sharding = NamedSharding(mesh, tp_param_spec((name, leaf)))
                if "model" not in sharding.spec:
                    self._put(rep, leaf, _as_leaf(t, self.devices[0], param))
                    continue
                for m, dev in enumerate(self.devices):
                    piece = t[sharding.index(t.shape, (row, m))]
                    self._put(shards[m], leaf, _as_leaf(piece, dev, param))

    @staticmethod
    def _put(holder: nn.Module, leaf: str, t) -> None:
        if isinstance(t, nn.Parameter):
            holder.register_parameter(leaf, t)
        else:
            holder.register_buffer(leaf, t)

    def holders(self, name: str):
        """(the shards, the replicated holder) of ``cls_fc1`` or ``cls_fc2``."""
        return (self.fc1, self.rep1) if name == "cls_fc1" else (self.fc2, self.rep2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = self.devices[0]
        if not self.int8:
            parts = []
            for m, dev in enumerate(self.devices):
                h = F.relu(F.linear(x.to(dev), self.fc1[m].weight, self.fc1[m].bias))
                parts.append(F.linear(h, self.fc2[m].weight))
            return sum_to(parts, lead) + self.rep2.bias
        b = x.shape[0]
        xs1 = self._input_scale(self.rep1, [x])
        xq = requantize(x, per_row(xs1, 2))
        hs = []
        for m, dev in enumerate(self.devices):
            s = self.fc1[m]
            acc = int_mm(xq.to(dev), s.wq).float()
            cols = slice(m * acc.shape[1], (m + 1) * acc.shape[1])
            y = acc.view(b, -1, acc.shape[1]) * (
                self.rep1.wscale[cols].to(dev) * per_row(xs1.to(dev), 3))
            hs.append(F.relu((y + s.bias).reshape(b, -1)))
        xs2 = self._input_scale(self.rep2, hs)
        accs = [int_mm(requantize(h, per_row(xs2.to(h.device), 2)), self.fc2[m].wq)
                for m, h in enumerate(hs)]
        acc = sum_to(accs, lead).float()
        y = acc.view(b, -1, acc.shape[1]) * (self.rep2.wscale * per_row(xs2, 3)) + self.rep2.bias
        return y.reshape(b, -1)

    def _input_scale(self, rep: nn.Module, parts: List[torch.Tensor]) -> torch.Tensor:
        """The layer's calibrated input scale, else the dynamic one (per
        batch element) of the whole input, whose columns ``parts`` hold."""
        if getattr(rep, "xmax", None) is not None:
            return scale_from_max(rep.xmax)
        if len(parts) == 1:
            return dynamic_scale(parts[0])
        amax = torch.stack([p.float().abs().amax(dim=1).to(self.devices[0]) for p in parts])
        return scale_from_max(amax.amax(dim=0))


def _get(module: nn.Module, dotted: str):
    return functools.reduce(getattr, dotted.split("."), module)


class MeshReplicas(nn.Module):
    """``net`` placed on ``mesh``: ``replicas[r]`` a copy of it on data row
    ``r``'s first device.  With a ``model`` axis longer than 1 and a net
    that has the UFLD head (``cls_fc1`` -> ReLU -> ``cls_fc2``), each
    replica's head is a :class:`TensorParallelMLP` over the row's devices,
    registered as the replica's ``mlp`` in place of the pair.
    ``whole_params`` / ``whole_buffers`` name the unsharded net's leaves in
    its order."""

    def __init__(self, net: nn.Module, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        self.whole_params = [k for k, _ in net.named_parameters()]
        self.whole_buffers = [k for k, _ in net.named_buffers()]
        has_head = all(isinstance(getattr(net, k, None), nn.Linear) for k in TP_MODULES)
        self.tp = mesh.axis_size("model") > 1 and has_head
        reps = []
        for r, row in enumerate(mesh.devices):
            rep = replicate(net, row[0], skip=TP_MODULES if self.tp else ())
            if self.tp:
                rep.mlp = TensorParallelMLP(net.cls_fc1, net.cls_fc2, mesh, r)
            reps.append(rep)
        self.replicas = nn.ModuleList(reps)

    def cells(self, name: str) -> List[List[torch.Tensor]]:
        """Each row's tensors that hold leaf ``name`` of the whole net: the
        shards in column order for a split head leaf, else the one copy."""
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        out = []
        for rep in self.replicas:
            if self.tp and mod in TP_MODULES:
                shards, holder = rep.mlp.holders(mod)
                if "model" in tp_param_spec(name):
                    out.append([getattr(s, leaf) for s in shards])
                    continue
                out.append([getattr(holder, leaf)])
            else:
                out.append([_get(rep, name)])
        return out

    def _sharding(self, name: str) -> NamedSharding:
        """How leaf ``name``'s copies split it: by its spec in a split
        head, else not at all."""
        split = self.tp and name.split(".")[0] in TP_MODULES
        return NamedSharding(self.mesh, tp_param_spec(name) if split else P())

    def gather(self, names: Sequence[str] = None, of=None) -> "OrderedDict[str, torch.Tensor]":
        """Whole leaves (row 0's, the split ones concatenated), on row 0's
        device: every parameter and buffer of the unsharded net by default.
        ``of(t)`` gathers a tensor of each cell's tensor ``t`` instead (its
        momentum, say); a leaf for which it gives None is left out."""
        names = self.whole_params + self.whole_buffers if names is None else names
        lead = self.mesh.devices[0, 0]
        out = OrderedDict()
        for k in names:
            row = [t.detach() if of is None else of(t) for t in self.cells(k)[0]]
            if any(v is None for v in row):
                continue
            spec = self._sharding(k).spec
            out[k] = row[0].to(lead, copy=True) if "model" not in spec else \
                torch.cat([v.to(lead) for v in row], dim=spec.index("model"))
        return out

    @torch.no_grad()
    def scatter(self, whole: Mapping[str, torch.Tensor], put=None) -> None:
        """Whole leaves into every replica, the split ones cut into their
        shards: ``put(t, piece)`` writes each cell's piece for its tensor
        ``t`` (default: copies it into ``t``)."""
        for k, v in whole.items():
            sharding = self._sharding(k)
            for r, row in enumerate(self.cells(k)):
                for m, t in enumerate(row):
                    piece = v[sharding.index(v.shape, (r, m))]
                    if put is None:
                        t.copy_(piece.to(t.device))
                    else:
                        put(t, piece)
        for rep in self.replicas:
            reset_int8_cache(rep)

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Sum each parameter's gradients across its copies and write the
        sum into every copy: a replicated leaf over all rows (and, in the
        head, the one copy each row holds), a split leaf's shards across
        the data rows of their column.  A copy without a gradient counts
        as zero."""
        for k in self.whole_params:
            cells = self.cells(k)
            groups = [[row[m] for row in cells] for m in range(len(cells[0]))]
            for group in groups:
                grads = [t.grad for t in group if t.grad is not None]
                if not grads:
                    continue
                total = sum_to(grads, group[0].device)
                for t in group:
                    if t.grad is None:
                        t.grad = total.to(t.device, copy=True)
                    elif t.grad is not total:
                        t.grad.copy_(total)


def shard_ufld_params(variables: Union[nn.Module, Any], mesh: Mesh) -> MeshReplicas:
    """Place a UFLD net on the mesh with tensor parallelism on its MLP head
    (``sharding.py:47-52``; JAX's variables tree is the port's module)."""
    return MeshReplicas(variables, mesh)
