"""ONNX graph executor: interpret an exported ``.onnx`` graph with torch ops
on the engine's device (port of ``adas_tpu/engine/onnx_engine.py``).

The graph is parsed by ``tools/onnx_graph.py`` (no onnx package) and run
node by node, eagerly: there is no tracing and nothing is compiled.  The
op table is JAX's, one entry per ONNX op (``_OPS``); an entry computes in
numpy when every operand is static and in torch otherwise.

- Static values (the ``Shape`` -> ``Gather`` -> ``Concat`` -> ``Reshape``
  chains; the initializers that reshape targets, slice bounds, resize
  sizes ... read, found by a backward walk from the positions that must
  be static, ``_required_static``) are host numpy arrays.  Every other
  value is a torch tensor on the engine's device, the other initializers
  uploaded once at construction.
- Ops whose output shape depends on the data (``NonMaxSuppression``,
  ``NonZero``) split the graph at the first of them: the prefix runs on
  the device, the tail on the host in numpy (``DYNAMIC_OPS``, JAX's host
  tail).
- ``Conv`` and ``ConvTranspose`` run ``torch.nn.functional``'s
  convolutions (JAX's are ``lax.conv``, outside any Pallas kernel), under
  the process's TF32 settings, as the port's f32 nets do.

Where numpy and JAX differ from torch in their rules (type promotion, a
negative slice step, ties in ``TopK``) an entry follows JAX's: a static
f64 operand meets a tensor as f32, as JAX without x64 takes it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tools.onnx_graph import OnnxModel, OnnxNode, parse_onnx, toposort
from ..tools.onnx_import import _DTYPES
from .base import EngineBase
from .torch_engine import torch_dtype

# ---------------------------------------------------------------------------
# op registry


class _Ctx:
    def __init__(self, opset: int, device: torch.device):
        self.opset = opset
        self.device = device


_OPS: Dict[str, Callable] = {}

#: ops whose output shape depends on input *values*: the host tail
DYNAMIC_OPS = frozenset({"NonMaxSuppression", "NonZero"})

#: op -> input positions that must be static (host numpy)
_STATIC_ARGS = {
    "Reshape": (1,),
    "Expand": (1,),
    "Tile": (1,),
    "ConstantOfShape": (0,),
    "Slice": (1, 2, 3, 4),
    "Resize": (1, 2, 3),
    "Upsample": (1,),
    "Pad": (1, 2, 3),
    "TopK": (1,),
    "Split": (1,),
    "Squeeze": (1,),
    "Unsqueeze": (1,),
    "ReduceMean": (1,),
    "ReduceSum": (1,),
    "ReduceMax": (1,),
    "ReduceMin": (1,),
    "ReduceProd": (1,),
    "Range": (0, 1, 2),
    "OneHot": (1,),
}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn

    return deco


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _np(v) -> np.ndarray:
    """Any value on the host as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def _ints(v) -> List[int]:
    return [int(x) for x in _np(v).reshape(-1)]


def _t(ctx: _Ctx, v):
    """A value as a torch tensor on the engine's device (a static f64 array
    as f32, as JAX without x64 takes it)."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


class _TorchNS:
    """The numpy names the op entries use, over torch tensors."""

    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    sqrt = staticmethod(torch.sqrt)
    tanh = staticmethod(torch.tanh)
    abs = staticmethod(torch.abs)
    floor = staticmethod(torch.floor)
    ceil = staticmethod(torch.ceil)
    round = staticmethod(torch.round)
    sign = staticmethod(torch.sign)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    logical_not = staticmethod(torch.logical_not)
    logical_and = staticmethod(torch.logical_and)
    logical_or = staticmethod(torch.logical_or)
    power = staticmethod(torch.pow)
    mod = staticmethod(torch.remainder)
    matmul = staticmethod(torch.matmul)
    tile = staticmethod(torch.tile)
    moveaxis = staticmethod(torch.movedim)

    @staticmethod
    def where(c, a, b):
        return torch.where(c.bool(), a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def reshape(x, shape):
        return x.reshape(tuple(shape))

    @staticmethod
    def transpose(x, perm):
        return x.permute(*perm)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(list(xs), dim=axis)

    @staticmethod
    def expand_dims(x, axis):
        return x.unsqueeze(axis)

    @staticmethod
    def squeeze(x, axis=None):
        return x.squeeze() if axis is None else x.squeeze(axis)

    @staticmethod
    def broadcast_to(x, shape):
        return torch.broadcast_to(x, tuple(shape))

    @staticmethod
    def take(x, ind, axis):
        ind = ind.long()
        flat = torch.index_select(x, axis, ind.reshape(-1))
        return flat.reshape(*x.shape[:axis], *ind.shape, *x.shape[axis + 1:])

    @staticmethod
    def take_along_axis(x, ind, axis):
        return torch.gather(x, axis, ind.long())

    @staticmethod
    def mean(x, axis=None, keepdims=False):
        return torch.mean(x, dim=_axes(axis), keepdim=keepdims)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return torch.sum(x, dim=_axes(axis), keepdim=keepdims)

    @staticmethod
    def max(x, axis=None, keepdims=False):
        return torch.amax(x, dim=() if axis is None else _axes(axis), keepdim=keepdims)

    @staticmethod
    def min(x, axis=None, keepdims=False):
        return torch.amin(x, dim=() if axis is None else _axes(axis), keepdim=keepdims)

    @staticmethod
    def prod(x, axis=None, keepdims=False):
        axes = range(x.dim()) if axis is None else axis if isinstance(axis, tuple) else (axis,)
        for a in sorted((a % x.dim() for a in axes), reverse=True):
            x = torch.prod(x, dim=a, keepdim=keepdims)
        return x

    @staticmethod
    def argmax(x, axis):
        return torch.argmax(x, dim=axis)

    @staticmethod
    def argmin(x, axis):
        return torch.argmin(x, dim=axis)

    @staticmethod
    def eye(n, dtype):
        return torch.eye(n, dtype=torch_dtype(dtype))


_T = _TorchNS()


def _xp(ctx: _Ctx, vals):
    """(numpy, vals) when every operand is static (shape math stays on the
    host); else (the torch namespace, vals as device tensors)."""
    if all(_is_static(v) for v in vals if v is not None):
        return np, list(vals)
    return _T, [_t(ctx, v) for v in vals]


def _astype(v, dtype):
    return v.astype(dtype) if _is_static(v) else v.to(torch_dtype(dtype))


# --- elementwise ----------------------------------------------------------

_UNARY = {
    "Relu": lambda m, x: np.maximum(x, 0) if m is np else torch.relu(x),
    "Sigmoid": lambda m, x: 1 / (1 + np.exp(-x)) if m is np else torch.sigmoid(x),
    "Tanh": lambda m, x: m.tanh(x),
    "Exp": lambda m, x: m.exp(x),
    "Log": lambda m, x: m.log(x),
    "Sqrt": lambda m, x: m.sqrt(x),
    "Neg": lambda m, x: -x,
    "Abs": lambda m, x: m.abs(x),
    "Floor": lambda m, x: m.floor(x),
    "Ceil": lambda m, x: m.ceil(x),
    "Round": lambda m, x: m.round(x),
    "Reciprocal": lambda m, x: 1 / x,
    "Erf": lambda m, x: torch.erf(x) if m is _T else _np_erf(x),
    "Not": lambda m, x: m.logical_not(x),
    "Identity": lambda m, x: x,
    "Sign": lambda m, x: m.sign(x),
    "Sin": lambda m, x: m.sin(x),
    "Cos": lambda m, x: m.cos(x),
}


def _np_erf(x):
    return np.vectorize(math.erf)(np.asarray(x, np.float64)).astype(np.asarray(x).dtype)


@op(*_UNARY)
def _unary(ctx, node, vals):
    m, vals = _xp(ctx, vals)
    return _UNARY[node.op_type](m, vals[0])


_BINARY = {
    "Add": lambda m, a, b: a + b,
    "Sub": lambda m, a, b: a - b,
    "Mul": lambda m, a, b: a * b,
    "Div": lambda m, a, b: a / b,
    "Pow": lambda m, a, b: m.power(a, b),
    "Equal": lambda m, a, b: a == b,
    "Greater": lambda m, a, b: a > b,
    "GreaterOrEqual": lambda m, a, b: a >= b,
    "Less": lambda m, a, b: a < b,
    "LessOrEqual": lambda m, a, b: a <= b,
    "And": lambda m, a, b: m.logical_and(a, b),
    "Or": lambda m, a, b: m.logical_or(a, b),
    "Mod": lambda m, a, b: m.mod(a, b),
}


@op(*_BINARY)
def _binary(ctx, node, vals):
    m, vals = _xp(ctx, vals)
    return _BINARY[node.op_type](m, vals[0], vals[1])


@op("Min", "Max", "Sum", "Mean")
def _variadic(ctx, node, vals):
    m, vals = _xp(ctx, vals)
    acc = vals[0]
    for v in vals[1:]:
        if node.op_type == "Min":
            acc = m.minimum(acc, v)
        elif node.op_type == "Max":
            acc = m.maximum(acc, v)
        else:
            acc = acc + v
    if node.op_type == "Mean":
        acc = acc / len(vals)
    return acc


@op("Clip")
def _clip(ctx, node, vals):
    if ctx.opset >= 11:
        lo = vals[1] if len(vals) > 1 and vals[1] is not None else None
        hi = vals[2] if len(vals) > 2 and vals[2] is not None else None
    else:
        lo, hi = node.attrs.get("min"), node.attrs.get("max")
    m, (x, lo, hi) = _xp(ctx, [vals[0], lo, hi])
    if lo is not None:
        x = m.maximum(x, lo)
    if hi is not None:
        x = m.minimum(x, hi)
    return x


@op("LeakyRelu")
def _leaky(ctx, node, vals):
    alpha = node.attrs.get("alpha", 0.01)
    m, (x,) = _xp(ctx, vals)
    return m.where(x >= 0, x, alpha * x)


@op("Elu")
def _elu(ctx, node, vals):
    alpha = node.attrs.get("alpha", 1.0)
    m, (x,) = _xp(ctx, vals)
    return m.where(x >= 0, x, alpha * (m.exp(x) - 1))


@op("PRelu")
def _prelu(ctx, node, vals):
    m, (x, slope) = _xp(ctx, vals)
    # the slope broadcasts over channel axis 1 (unidirectional numpy rules)
    if slope.ndim == 1 and x.ndim > 2:
        slope = m.reshape(slope, (-1,) + (1,) * (x.ndim - 2))
    return m.where(x >= 0, x, slope * x)


@op("HardSigmoid")
def _hardsigmoid(ctx, node, vals):
    alpha = node.attrs.get("alpha", 0.2)
    beta = node.attrs.get("beta", 0.5)
    m, (x,) = _xp(ctx, vals)
    return m.clip(alpha * x + beta, 0, 1)


@op("HardSwish")
def _hardswish(ctx, node, vals):
    m, (x,) = _xp(ctx, vals)
    return x * m.clip(x / 6 + 0.5, 0, 1)


@op("Softplus")
def _softplus(ctx, node, vals):
    m, (x,) = _xp(ctx, vals)
    return m.log(1 + m.exp(x))


@op("Gelu")
def _gelu(ctx, node, vals):
    x = _t(ctx, vals[0])
    tanh = node.attrs.get("approximate", "none") == "tanh"
    return F.gelu(x, approximate="tanh" if tanh else "none")


@op("Cast")
def _cast(ctx, node, vals):
    dtype = np.dtype(_DTYPES[int(node.attrs["to"])])
    v = vals[0]
    return np.asarray(v).astype(dtype) if _is_static(v) else v.to(torch_dtype(dtype))


@op("Where")
def _where(ctx, node, vals):
    m, (c, a, b) = _xp(ctx, vals)
    return m.where(c, a, b)


# --- shape / layout -------------------------------------------------------


@op("Shape")
def _shape(ctx, node, vals):
    shape = np.asarray(tuple(np.shape(vals[0])), np.int64)
    start = node.attrs.get("start", 0)
    end = node.attrs.get("end")
    return shape[start:end] if (start or end is not None) else shape


@op("Size")
def _size(ctx, node, vals):
    return np.asarray(int(np.prod(tuple(np.shape(vals[0])))), np.int64)


@op("Reshape")
def _reshape(ctx, node, vals):
    x = vals[0]
    target = _ints(vals[1] if len(vals) > 1 else node.attrs["shape"])
    allowzero = node.attrs.get("allowzero", 0)
    in_shape = list(np.shape(x))
    out = [in_shape[i] if d == 0 and not allowzero else d for i, d in enumerate(target)]
    return x.reshape(tuple(out))


@op("Flatten")
def _flatten(ctx, node, vals):
    x = vals[0]
    axis = node.attrs.get("axis", 1)
    shape = tuple(np.shape(x))
    lead = int(np.prod(shape[:axis])) if axis else 1
    return x.reshape((lead, -1))


@op("Transpose")
def _transpose(ctx, node, vals):
    x = vals[0]
    perm = node.attrs.get("perm")
    if perm is None:
        perm = list(range(np.ndim(x)))[::-1]
    m, (x,) = _xp(ctx, [x])
    return m.transpose(x, perm)


@op("Concat")
def _concat(ctx, node, vals):
    m, vals = _xp(ctx, vals)
    return m.concatenate(vals, axis=node.attrs["axis"])


@op("Split")
def _split(ctx, node, vals):
    x = vals[0]
    axis = node.attrs.get("axis", 0)
    dim = np.shape(x)[axis]
    if len(vals) > 1 and vals[1] is not None:
        sizes = _ints(vals[1])
    elif "split" in node.attrs:
        sizes = _ints(node.attrs["split"])
    else:
        n = int(node.attrs.get("num_outputs", len(node.outputs)))
        q, r = divmod(dim, n)
        sizes = [q + 1] * r + [q] * (n - r)
    offsets = np.cumsum([0] + sizes)
    idx = [slice(None)] * np.ndim(x)
    outs = []
    for i, s in enumerate(sizes):
        idx[axis] = slice(int(offsets[i]), int(offsets[i] + s))
        outs.append(x[tuple(idx)])
    return tuple(outs)


def _torch_slice(x: torch.Tensor, idx: List[slice]) -> torch.Tensor:
    """``x[idx]`` with numpy's semantics, negative steps included (torch
    slices take positive steps only: those axes gather their indices)."""
    for axis, s in enumerate(idx):
        if s.step is not None and s.step < 0:
            index = torch.arange(*s.indices(x.shape[axis]), device=x.device)
            x = torch.index_select(x, axis, index)
        elif s != slice(None):
            x = x[(slice(None),) * axis + (s,)]
    return x


@op("Slice")
def _slice(ctx, node, vals):
    x = vals[0]
    nd = np.ndim(x)
    if ctx.opset >= 10 and len(vals) > 1:
        starts, ends = _ints(vals[1]), _ints(vals[2])
        axes = _ints(vals[3]) if len(vals) > 3 and vals[3] is not None \
            else list(range(len(starts)))
        steps = _ints(vals[4]) if len(vals) > 4 and vals[4] is not None \
            else [1] * len(starts)
    else:
        starts, ends = _ints(node.attrs["starts"]), _ints(node.attrs["ends"])
        axes = _ints(node.attrs.get("axes", list(range(len(starts)))))
        steps = [1] * len(starts)
    idx = [slice(None)] * nd
    for a, s, e, st in zip(axes, starts, ends, steps):
        a = a + nd if a < 0 else a
        # the spec clamps out-of-range bounds (an INT64_MAX sentinel is common)
        lim = 1 << 40
        s = None if s >= lim else s
        e = None if e >= lim else (None if (st < 0 and e <= -lim) else e)
        idx[a] = slice(s, e, st)
    if _is_static(x):
        return np.asarray(x)[tuple(idx)]
    return _torch_slice(x, idx)


@op("Squeeze")
def _squeeze(ctx, node, vals):
    x = vals[0]
    axes = None
    if len(vals) > 1 and vals[1] is not None:
        axes = _ints(vals[1])
    elif "axes" in node.attrs:
        axes = _ints(node.attrs["axes"])
    m, (x,) = _xp(ctx, [x])
    if axes is None:
        return m.squeeze(x)
    return m.squeeze(x, axis=tuple(a % np.ndim(x) for a in axes))


@op("Unsqueeze")
def _unsqueeze(ctx, node, vals):
    x = vals[0]
    axes = _ints(vals[1]) if len(vals) > 1 and vals[1] is not None else _ints(node.attrs["axes"])
    m, (x,) = _xp(ctx, [x])
    out_nd = np.ndim(x) + len(axes)
    for a in sorted(a % out_nd for a in axes):
        x = m.expand_dims(x, a)
    return x


@op("Gather")
def _gather(ctx, node, vals):
    axis = node.attrs.get("axis", 0)
    m, (x, ind) = _xp(ctx, vals)
    dim = np.shape(x)[axis]
    ind = m.where(ind < 0, ind + dim, ind)
    return m.take(x, ind, axis=axis)


@op("GatherElements")
def _gather_elements(ctx, node, vals):
    axis = node.attrs.get("axis", 0)
    m, (x, ind) = _xp(ctx, vals)
    ind = m.where(ind < 0, ind + np.shape(x)[axis], ind)
    return m.take_along_axis(x, ind, axis=axis)


@op("GatherND")
def _gather_nd(ctx, node, vals):
    if node.attrs.get("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims != 0")
    m, (x, ind) = _xp(ctx, vals)
    if m is _T:
        ind = ind.long()
    return x[tuple(m.moveaxis(ind, -1, 0))]


@op("ScatterND")
def _scatter_nd(ctx, node, vals):
    m, (data, indices, updates) = _xp(ctx, vals)
    if m is np:
        out = np.array(data)
        out[tuple(np.moveaxis(np.asarray(indices), -1, 0))] = updates
        return out
    out = data.clone()
    out[tuple(torch.movedim(indices.long(), -1, 0))] = updates.to(out.dtype)
    return out


@op("Expand")
def _expand(ctx, node, vals):
    x = vals[0]
    shape = np.broadcast_shapes(tuple(np.shape(x)), tuple(_ints(vals[1])))
    m, (x,) = _xp(ctx, [x])
    return m.broadcast_to(x, shape)


@op("Tile")
def _tile(ctx, node, vals):
    m, (x,) = _xp(ctx, [vals[0]])
    return m.tile(x, tuple(_ints(vals[1])))


@op("Pad")
def _pad(ctx, node, vals):
    x = vals[0]
    mode = node.attrs.get("mode", "constant")
    if ctx.opset >= 11 and len(vals) > 1 and vals[1] is not None:
        pads = _ints(vals[1])
        cval = vals[2] if len(vals) > 2 and vals[2] is not None else 0
    else:
        pads = _ints(node.attrs["pads"])
        cval = node.attrs.get("value", 0.0)
    nd = np.ndim(x)
    width = [(pads[i], pads[i + nd]) for i in range(nd)]
    np_mode = {"constant": "constant", "reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode]
    if _is_static(x):
        if mode == "constant":
            return np.pad(x, width, constant_values=float(_np(cval)))
        return np.pad(x, width, mode=np_mode)
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return F.pad(x, flat, value=float(_np(cval)))
    # edge / reflect / wrap: numpy's index map of each padded axis
    for axis, (lo, hi) in enumerate(width):
        if lo or hi:
            index = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, axis, torch.as_tensor(index, device=x.device))
    return x


@op("Constant")
def _constant(ctx, node, vals):
    a = node.attrs
    if "value" in a:
        return np.asarray(a["value"])
    if "value_float" in a:
        return np.asarray(a["value_float"], np.float32)
    if "value_int" in a:
        return np.asarray(a["value_int"], np.int64)
    if "value_floats" in a:
        return np.asarray(a["value_floats"], np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"], np.int64)
    raise NotImplementedError(f"Constant attrs {list(a)}")


@op("ConstantOfShape")
def _constant_of_shape(ctx, node, vals):
    shape = _ints(vals[0])
    value = node.attrs.get("value")
    if value is None:
        return np.zeros(shape, np.float32)
    value = np.asarray(value)
    return np.full(shape, value.reshape(-1)[0], value.dtype)


@op("Range")
def _range(ctx, node, vals):
    start, limit, delta = (_np(v).item() for v in vals)
    return np.arange(start, limit, delta, dtype=_np(vals[0]).dtype)


@op("OneHot")
def _onehot(ctx, node, vals):
    indices, depth, values = vals
    axis = node.attrs.get("axis", -1)
    depth = int(_np(depth).item())
    off, on = _np(values).reshape(-1)
    m, (ind,) = _xp(ctx, [indices])
    eye = m.eye(depth, dtype=_np(values).dtype)
    if m is _T:
        eye = eye.to(ind.device)
    hot = m.take(eye, ind % depth, axis=0)
    hot = hot * (on - off) + off
    if axis != -1 and axis != np.ndim(hot) - 1:
        hot = m.moveaxis(hot, -1, axis)
    return hot


# --- reductions / linear algebra ------------------------------------------


def _reduce(name: str):
    def impl(ctx, node, vals):
        x = vals[0]
        if len(vals) > 1 and vals[1] is not None:
            axes = _ints(vals[1])
        else:
            axes = node.attrs.get("axes")
            axes = _ints(axes) if axes is not None else None
        keep = bool(node.attrs.get("keepdims", 1))
        if axes is None and node.attrs.get("noop_with_empty_axes", 0):
            return x
        m, (x,) = _xp(ctx, [x])
        return getattr(m, name)(x, axis=tuple(axes) if axes is not None else None, keepdims=keep)

    return impl


for _op_name, _fn in (("ReduceMean", "mean"), ("ReduceSum", "sum"), ("ReduceMax", "max"),
                      ("ReduceMin", "min"), ("ReduceProd", "prod")):
    _OPS[_op_name] = _reduce(_fn)


@op("ReduceL2")
def _reduce_l2(ctx, node, vals):
    axes = node.attrs.get("axes")
    axis = tuple(_ints(axes)) if axes is not None else None
    keep = bool(node.attrs.get("keepdims", 1))
    m, (x,) = _xp(ctx, vals)
    return m.sqrt(m.sum(x * x, axis=axis, keepdims=keep))


@op("ArgMax", "ArgMin")
def _argmax(ctx, node, vals):
    axis = node.attrs.get("axis", 0)
    keep = bool(node.attrs.get("keepdims", 1))
    if node.attrs.get("select_last_index", 0):
        raise NotImplementedError("ArgMax select_last_index")
    m, (x,) = _xp(ctx, vals)
    fn = m.argmax if node.op_type == "ArgMax" else m.argmin
    r = _astype(fn(x, axis=axis), np.int64)
    return m.expand_dims(r, axis) if keep else r


@op("MatMul")
def _matmul(ctx, node, vals):
    m, (a, b) = _xp(ctx, vals)
    return m.matmul(a, b)


@op("Gemm")
def _gemm(ctx, node, vals):
    m, vals = _xp(ctx, vals)
    a, b = vals[0], vals[1]
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    y = alpha * m.matmul(a, b)
    if len(vals) > 2 and vals[2] is not None:
        y = y + beta * vals[2]
    return y


@op("Softmax")
def _softmax(ctx, node, vals):
    x = _t(ctx, vals[0])
    axis = node.attrs.get("axis", -1 if ctx.opset >= 13 else 1)
    if ctx.opset >= 13:
        return torch.softmax(x, dim=axis)
    # before opset 13: softmax over the input coerced to 2-D [prefix, suffix]
    axis = axis % x.dim()
    lead = int(np.prod(tuple(x.shape[:axis]))) if axis else 1
    return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(x.shape)


@op("LogSoftmax")
def _log_softmax(ctx, node, vals):
    axis = node.attrs.get("axis", -1 if ctx.opset >= 13 else 1)
    return torch.log_softmax(_t(ctx, vals[0]), dim=axis)


@op("LayerNormalization")
def _layernorm(ctx, node, vals):
    x, scale = _t(ctx, vals[0]), _t(ctx, vals[1])
    bias = _t(ctx, vals[2]) if len(vals) > 2 and vals[2] is not None else None
    axis = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    y = (x - mean) / torch.sqrt(var + eps) * scale
    return y + bias if bias is not None else y


@op("InstanceNormalization")
def _instancenorm(ctx, node, vals):
    x, scale, bias = (_t(ctx, v) for v in vals)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)


@op("BatchNormalization")
def _batchnorm(ctx, node, vals):
    eps = node.attrs.get("epsilon", 1e-5)
    m, (x, scale, bias, mean, var) = _xp(ctx, vals[:5])
    shape = (1, -1) + (1,) * (np.ndim(x) - 2)
    scale, bias, mean, var = (m.reshape(v, shape) for v in (scale, bias, mean, var))
    return (x - mean) / m.sqrt(var + eps) * scale + bias


# --- convolution / pooling -------------------------------------------------


def _conv_padding(node: OnnxNode, in_spatial, kernel, strides, dilations
                  ) -> List[Tuple[int, int]]:
    spatial = len(in_spatial)
    auto = node.attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(spatial):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            o = math.ceil(in_spatial[i] / strides[i])
            total = max((o - 1) * strides[i] + eff_k - in_spatial[i], 0)
            lo = total // 2
            hi = total - lo
            out.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return out
    if auto == "VALID":
        return [(0, 0)] * spatial
    pads = _ints(node.attrs.get("pads", [0] * 2 * spatial))
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _pad_spatial(x: torch.Tensor, padding, value: float = 0.0) -> torch.Tensor:
    """``x`` (N, C, *spatial) padded by (lo, hi) per spatial axis."""
    flat = [p for lo_hi in reversed(padding) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _add_bias(out: torch.Tensor, b, spatial: int) -> torch.Tensor:
    return out if b is None else out + b.reshape((1, -1) + (1,) * spatial)


@op("Conv")
def _conv(ctx, node, vals):
    x, w = _t(ctx, vals[0]), _t(ctx, vals[1])
    b = _t(ctx, vals[2]) if len(vals) > 2 else None
    spatial = w.dim() - 2
    strides = _ints(node.attrs.get("strides", [1] * spatial))
    dilations = _ints(node.attrs.get("dilations", [1] * spatial))
    group = int(node.attrs.get("group", 1))
    padding = _conv_padding(node, tuple(x.shape[2:]), list(w.shape[2:]), strides, dilations)
    out = _CONV[spatial](_pad_spatial(x, padding), w, None, strides, 0, dilations, group)
    return _add_bias(out, b, spatial)


@op("ConvTranspose")
def _conv_transpose(ctx, node, vals):
    x, w = _t(ctx, vals[0]), _t(ctx, vals[1])
    b = _t(ctx, vals[2]) if len(vals) > 2 else None
    spatial = w.dim() - 2
    strides = _ints(node.attrs.get("strides", [1] * spatial))
    dilations = _ints(node.attrs.get("dilations", [1] * spatial))
    if int(node.attrs.get("group", 1)) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    pads = _ints(node.attrs.get("pads", [0] * 2 * spatial))
    out_pad = _ints(node.attrs.get("output_padding", [0] * spatial))
    # the full transposed conv, then the pads cropped off and the output
    # padding appended as zeros (what JAX's lhs-dilated conv computes)
    full = _CONV_T[spatial](x, w, None, strides, 0, 0, 1, dilations)
    crop = [(-pads[i], -pads[i + spatial] + out_pad[i]) for i in range(spatial)]
    return _add_bias(_pad_spatial(full, crop), b, spatial)


def _pool_geometry(node, x):
    spatial = np.ndim(x) - 2
    kernel = _ints(node.attrs["kernel_shape"])
    strides = _ints(node.attrs.get("strides", [1] * spatial))
    dilations = _ints(node.attrs.get("dilations", [1] * spatial))
    padding = _conv_padding(node, tuple(np.shape(x))[2:], kernel, strides, dilations)
    if node.attrs.get("ceil_mode", 0):
        in_sp = tuple(np.shape(x))[2:]
        for i in range(spatial):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            total = padding[i][0] + padding[i][1]
            out_ceil = math.ceil((in_sp[i] + total - eff_k) / strides[i]) + 1
            # the last window must start inside the input + begin pad
            if (out_ceil - 1) * strides[i] >= in_sp[i] + padding[i][0]:
                out_ceil -= 1
            need = (out_ceil - 1) * strides[i] + eff_k - in_sp[i]
            padding[i] = (padding[i][0], max(need - padding[i][0], 0))
    return kernel, strides, dilations, padding


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@op("MaxPool")
def _maxpool(ctx, node, vals):
    if len(node.outputs) > 1:
        raise NotImplementedError("MaxPool indices output")
    x = _t(ctx, vals[0])
    kernel, strides, dilations, padding = _pool_geometry(node, x)
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    xp = _pad_spatial(x, padding, low)
    return _MAX_POOL[len(kernel)](xp, kernel, strides, 0, dilations)


def _window_sum(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    """Sum over each pooling window (no padding)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x[..., None], (kernel[0], 1), (strides[0], 1),
                            divisor_override=1)[..., 0]
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, strides, divisor_override=1)


@op("AveragePool")
def _avgpool(ctx, node, vals):
    x = _t(ctx, vals[0])
    kernel, strides, _, padding = _pool_geometry(node, x)
    summed = _window_sum(_pad_spatial(x, padding), kernel, strides)
    if node.attrs.get("count_include_pad", 0):
        return summed / float(np.prod(kernel))
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    return summed / _window_sum(_pad_spatial(ones, padding), kernel, strides)


@op("GlobalAveragePool")
def _gap(ctx, node, vals):
    m, (x,) = _xp(ctx, vals)
    return m.mean(x, axis=tuple(range(2, np.ndim(x))), keepdims=True)


@op("GlobalMaxPool")
def _gmp(ctx, node, vals):
    m, (x,) = _xp(ctx, vals)
    return m.max(x, axis=tuple(range(2, np.ndim(x))), keepdims=True)


# --- resize ----------------------------------------------------------------


def _resize_src_index(out_len, in_len, scale, ct_mode):
    i = np.arange(out_len, dtype=np.float64)
    if ct_mode == "half_pixel":
        return (i + 0.5) / scale - 0.5
    if ct_mode == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_len > 1 else np.zeros_like(i)
    if ct_mode == "asymmetric":
        return i / scale
    if ct_mode == "align_corners":
        if out_len == 1:
            return np.zeros_like(i)
        return i * (in_len - 1) / (out_len - 1)
    raise NotImplementedError(f"coordinate_transformation_mode {ct_mode}")


def _nearest_round(x, mode):
    if mode == "floor":
        return np.floor(x)
    if mode == "ceil":
        return np.ceil(x)
    if mode == "round_prefer_ceil":
        return np.floor(x + 0.5)
    return np.ceil(x - 0.5)  # round_prefer_floor (default)


@op("Resize", "Upsample")
def _resize(ctx, node, vals):
    x = _t(ctx, vals[0])
    in_shape = list(x.shape)
    nd = len(in_shape)
    if node.op_type == "Upsample":
        scales = (_np(vals[1]).astype(np.float64).reshape(-1)
                  if len(vals) > 1 and vals[1] is not None
                  else np.asarray(node.attrs["scales"], np.float64))
        sizes = [int(math.floor(in_shape[i] * scales[i])) for i in range(nd)]
        ct_mode, nearest_mode = "asymmetric", "floor"
    else:
        scales = None
        if len(vals) > 2 and vals[2] is not None and np.size(_np(vals[2])):
            scales = _np(vals[2]).astype(np.float64).reshape(-1)
            sizes = [int(math.floor(in_shape[i] * scales[i])) for i in range(nd)]
        elif len(vals) > 3 and vals[3] is not None:
            sizes = _ints(vals[3])
        else:
            raise ValueError("Resize needs scales or sizes")
        ct_mode = node.attrs.get("coordinate_transformation_mode", "half_pixel")
        nearest_mode = node.attrs.get("nearest_mode", "round_prefer_floor")
    mode = node.attrs.get("mode", "nearest")
    for axis in range(nd):
        if sizes[axis] == in_shape[axis]:
            continue
        scale = scales[axis] if scales is not None else sizes[axis] / in_shape[axis]
        src = _resize_src_index(sizes[axis], in_shape[axis], scale, ct_mode)
        if mode == "nearest":
            idx = np.clip(_nearest_round(src, nearest_mode), 0, in_shape[axis] - 1)
            x = torch.index_select(x, axis, torch.as_tensor(idx.astype(np.int64), device=x.device))
        elif mode == "linear":
            lo = np.clip(np.floor(src), 0, in_shape[axis] - 1).astype(np.int64)
            hi = np.clip(lo + 1, 0, in_shape[axis] - 1)
            shape = [1] * x.dim()
            shape[axis] = -1
            w_hi = torch.as_tensor(np.clip(src - lo, 0.0, 1.0).astype(np.float32),
                                   device=x.device).reshape(shape)
            x = (torch.index_select(x, axis, torch.as_tensor(lo, device=x.device)) * (1 - w_hi)
                 + torch.index_select(x, axis, torch.as_tensor(hi, device=x.device)) * w_hi)
        else:
            raise NotImplementedError(f"Resize mode {mode}")
    return x


# --- misc ------------------------------------------------------------------


@op("TopK")
def _topk(ctx, node, vals):
    x = _t(ctx, vals[0])
    k = int(_np(vals[1]).reshape(-1)[0]) if len(vals) > 1 else int(node.attrs["k"])
    axis = node.attrs.get("axis", -1)
    largest = bool(node.attrs.get("largest", 1))
    # a stable sort: equal values keep index order, as lax.top_k
    values, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return values.narrow(axis, 0, k), idx.narrow(axis, 0, k)


@op("NonMaxSuppression")
def _nms(ctx, node, vals):
    """Greedy NMS with ONNX's semantics (selected_indices (n, 3)), on the
    host: it runs in the tail."""
    boxes = _np(vals[0]).astype(np.float32)
    scores = _np(vals[1]).astype(np.float32)
    max_out = (int(_np(vals[2]).reshape(-1)[0])
               if len(vals) > 2 and vals[2] is not None else 0)
    iou_th = (float(_np(vals[3]).reshape(-1)[0])
              if len(vals) > 3 and vals[3] is not None else 0.0)
    score_th = (float(_np(vals[4]).reshape(-1)[0])
                if len(vals) > 4 and vals[4] is not None else -np.inf)
    center = node.attrs.get("center_point_box", 0)
    selected = []
    for b in range(boxes.shape[0]):
        bx = boxes[b]
        if center:
            cx, cy, w, h = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
            x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
        else:
            y1, x1, y2, x2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
            y1, y2 = np.minimum(y1, y2), np.maximum(y1, y2)
            x1, x2 = np.minimum(x1, x2), np.maximum(x1, x2)
        area = (x2 - x1) * (y2 - y1)
        for c in range(scores.shape[1]):
            sc = scores[b, c]
            order = np.argsort(-sc)
            order = order[sc[order] > score_th]
            kept = []
            while order.size and (not max_out or len(kept) < max_out):
                i = order[0]
                kept.append(i)
                rest = order[1:]
                xx1 = np.maximum(x1[i], x1[rest])
                yy1 = np.maximum(y1[i], y1[rest])
                xx2 = np.minimum(x2[i], x2[rest])
                yy2 = np.minimum(y2[i], y2[rest])
                inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
                iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-9)
                order = rest[iou <= iou_th]
            selected.extend((b, c, int(i)) for i in kept)
    return np.asarray(selected, np.int64).reshape(-1, 3)


@op("NonZero")
def _nonzero(ctx, node, vals):
    return np.asarray(np.nonzero(_np(vals[0])), np.int64)


@op("Dropout")
def _dropout(ctx, node, vals):
    if len(node.outputs) > 1:
        return vals[0], np.ones(tuple(np.shape(vals[0])), bool)
    return vals[0]


def _per_axis(m, v, x, axis):
    """A per-channel (1-D) quantization parameter shaped along ``axis``."""
    shape = [1] * np.ndim(x)
    shape[axis] = -1
    return m.reshape(v, shape)


@op("DequantizeLinear")
def _dequant(ctx, node, vals):
    zp = vals[2] if len(vals) > 2 and vals[2] is not None else np.int32(0)
    axis = node.attrs.get("axis", 1)
    m, (x, scale, zp) = _xp(ctx, [vals[0], vals[1], zp])
    if np.ndim(scale) == 1 and np.size(scale) > 1:
        scale = _per_axis(m, scale, x, axis)
        if np.ndim(zp) == 1:
            zp = _per_axis(m, zp, x, axis)
    return _astype(_astype(x, np.int32) - _astype(zp, np.int32), np.float32) * scale


@op("QuantizeLinear")
def _quant(ctx, node, vals):
    zp = vals[2] if len(vals) > 2 and vals[2] is not None else np.uint8(0)
    zdt = _np(zp).dtype
    axis = node.attrs.get("axis", 1)
    m, (x, scale, zp) = _xp(ctx, [vals[0], vals[1], zp])
    if np.ndim(scale) == 1 and np.size(scale) > 1:
        scale = _per_axis(m, scale, x, axis)
        if np.ndim(zp) == 1:
            zp = _per_axis(m, zp, x, axis)
    info = np.iinfo(zdt)
    q = m.round(x / scale) + zp
    return _astype(m.clip(q, info.min, info.max), zdt)


# ---------------------------------------------------------------------------
# executor


def _required_static(nodes: Sequence[OnnxNode]) -> set:
    """The values that must be static, walked back from the
    ``_STATIC_ARGS`` positions through their producers (``Shape``,
    ``Size``, ``Constant*`` and ``Range`` emit static values whatever
    their inputs)."""
    produced_by = {o: node for node in nodes for o in node.outputs}
    needed = set()
    for node in nodes:
        for pos in _STATIC_ARGS.get(node.op_type, ()):
            if pos < len(node.inputs) and node.inputs[pos]:
                needed.add(node.inputs[pos])
    frontier = list(needed)
    while frontier:
        node = produced_by.get(frontier.pop())
        if node is None or node.op_type in ("Shape", "Size", "Constant", "ConstantOfShape",
                                            "Range"):
            continue
        for i in node.inputs:
            if i and i not in needed:
                needed.add(i)
                frontier.append(i)
    return needed


class OnnxGraphEngine(EngineBase):
    """Run a parsed ONNX graph on ``device``: one NCHW input, the outputs
    in graph order, ``engine_dtype`` the input's element type (an fp16
    model is fed fp16)."""

    framework_type = "onnx-torch"

    def __init__(self, model_path, batch_size: int = 1, device="cuda"):
        from ..perception.object_detector import resolve_device

        model: OnnxModel = model_path if isinstance(model_path, OnnxModel) \
            else parse_onnx(model_path)
        self._model = model
        g = model.graph
        self.device = resolve_device(device)
        self.providers = self.device.type
        self._ctx = _Ctx(model.opset, self.device)
        self._nodes = toposort(g)
        unsupported = sorted({n.op_type for n in self._nodes} - set(_OPS))
        if unsupported:
            raise NotImplementedError(f"ONNX ops not supported by the executor: {unsupported}")
        data_inputs = g.data_inputs
        if len(data_inputs) != 1:
            raise ValueError(f"expected exactly 1 graph input, got "
                             f"{[v.name for v in data_inputs]}")
        vi = data_inputs[0]
        if vi.shape is None:
            raise ValueError(f"input {vi.name} has no static shape")
        shape = [d if d else (batch_size if i == 0 else None) for i, d in enumerate(vi.shape)]
        if any(d is None for d in shape):
            raise ValueError(f"input {vi.name} has dynamic non-batch dims {vi.shape}")
        self._input_name = vi.name
        self._input_shape = tuple(int(d) for d in shape)
        self._dtype = np.dtype(vi.dtype)
        self._output_names = [v.name for v in g.outputs]
        self._declared_output_shapes = [tuple(d if d else 1 for d in (v.shape or ()))
                                        for v in g.outputs]
        static_names = _required_static(self._nodes)
        self._static_inits = {k: v for k, v in g.initializers.items() if k in static_names}
        self._params = {k: _t(self._ctx, v) for k, v in g.initializers.items()
                        if k not in static_names}
        # split at the first op with a data-dependent output shape
        split = next((i for i, n in enumerate(self._nodes) if n.op_type in DYNAMIC_OPS), None)
        if split is None:
            self._prefix, self._tail = self._nodes, []
            self._bridge = list(self._output_names)
        else:
            self._prefix, self._tail = self._nodes[:split], self._nodes[split:]
            produced = {o for n in self._prefix for o in n.outputs}
            needed_by_tail = {i for n in self._tail for i in n.inputs if i}
            needed_by_tail.update(self._output_names)
            self._bridge = sorted(produced & needed_by_tail)
        self._output_shapes: Optional[List[Tuple[int, ...]]] = None

    def _run_nodes(self, nodes, env) -> None:
        for node in nodes:
            vals = [env[i] if i else None for i in node.inputs]
            out = _OPS[node.op_type](self._ctx, node, vals)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = out
            else:
                if not isinstance(out, tuple):
                    out = (out,)
                for name, v in zip(node.outputs, out):
                    if name:
                        env[name] = v

    @torch.inference_mode()
    def _run_prefix(self, x: torch.Tensor) -> tuple:
        env = dict(self._static_inits)
        env.update(self._params)
        env[self._input_name] = x
        self._run_nodes(self._prefix, env)
        return tuple(_t(self._ctx, env[name]) for name in self._bridge)

    def _execute(self, x: torch.Tensor) -> list:
        bridge = self._run_prefix(x)
        if not self._tail:
            return list(bridge)
        env = dict(self._static_inits)
        env.update({k: _np(v) for k, v in zip(self._bridge, bridge)})
        # the tail may read the other initializers too
        for k, v in self._model.graph.initializers.items():
            env.setdefault(k, v)
        env[self._input_name] = _np(x)
        self._run_nodes(self._tail, env)
        return [env[name] for name in self._output_names]

    # -- EngineBase ----------------------------------------------------------

    def get_engine_input_shape(self) -> Sequence[int]:
        return self._input_shape

    def get_engine_output_shape(self):
        if self._output_shapes is None:
            if self._tail:
                # data-dependent shapes: the graph's declared ones
                self._output_shapes = list(self._declared_output_shapes)
            else:
                x = torch.zeros(self._input_shape, dtype=torch_dtype(self._dtype),
                                device=self.device)
                self._output_shapes = [tuple(o.shape) for o in self._run_prefix(x)]
        return self._output_shapes, list(self._output_names)

    @property
    def engine_dtype(self):
        return self._dtype

    def engine_inference(self, input_tensor: np.ndarray) -> List[np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(input_tensor, self._dtype)))
        return [_np(o) for o in self._execute(x.to(self.device))]

    def device_inference(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The prefix on the device; a host tail's outputs come back up."""
        outs = self._execute(x.to(self.device, torch_dtype(self._dtype)))
        return [o if isinstance(o, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(o)).to(self.device) for o in outs]

    def run_device(self, x: torch.Tensor):
        """Device-resident execution (no host copies), for graphs without a
        host tail: the outputs as a tuple of device tensors."""
        if self._tail:
            raise ValueError("graph has a host tail (NonMaxSuppression/NonZero); use "
                             "engine_inference")
        return self._run_prefix(x)
