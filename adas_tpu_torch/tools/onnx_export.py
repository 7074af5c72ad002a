"""torch.export graph -> ONNX exporter for the port's nets (port of
``adas_tpu/tools/onnx_export.py``, which walks a jaxpr).

The function is traced with ``torch.export.export(..., strict=False)``
after one eager call (which fills the modules' caches, e.g. the stem's
folded BN, so that the export lifts them as constants).  The exported
graph is walked as it comes, without ``run_decompositions()``: its
high-level ATen ops map one to one onto ONNX nodes, written with the
port's ``tools/onnx_writer.py`` (no ``onnx`` package).  Every node whose
inputs are all parameters, buffers or constants (a YOLO head's anchor
grid: ``arange``, ``meshgrid``, ``stack``, ``full``) is evaluated at
export time and written as an initializer, as JAX's jaxpr consts are.

Mapped ops (ATen -> ONNX): ``conv2d`` -> Conv; ``batch_norm`` (eval) ->
BatchNormalization; ``layer_norm`` -> LayerNormalization; ``linear`` ->
Gemm (2-D input) or MatMul + Add; ``relu`` -> Relu; ``sigmoid`` ->
Sigmoid; ``silu`` -> Sigmoid + Mul; ``tanh``/``exp``/``log``/``sqrt``/
``neg``/``abs`` -> the op of that name; ``add``/``sub``/``mul``/``div``
(Tensor or Scalar) -> Add/Sub/Mul/Div; ``max_pool2d`` -> MaxPool;
``upsample_nearest2d`` -> Resize (nearest, asymmetric, floor);
``upsample_bilinear2d`` -> Resize (linear, half_pixel or align_corners);
``softmax`` -> Softmax; ``sum.dim_IntList`` / ``mean.dim`` -> ReduceSum /
ReduceMean; ``cat`` -> Concat; ``slice`` -> Slice; ``permute`` ->
Transpose; ``reshape``/``view``/``flatten``/``unsqueeze``/``squeeze`` ->
Reshape; ``expand`` -> Expand; ``to``/``_to_copy`` -> Cast (bf16 as f32,
as JAX's exporter writes it); ``clone``/``contiguous``/``alias``/
``detach`` -> Identity.  The port's stem operator
(``adas_tpu_torch::fused_stem``) is lowered to Conv (stride 2, pad k//2)
-> Mul (folded gain) -> Add (folded bias) -> act (-> MaxPool 3/2 pad 1),
the arithmetic of its plain version (``ops/stem.stem_reference``).  The
int8 operators (``int8_conv``, ``fused_block``) have no ONNX form and
raise :class:`ExportError`, as a ``pallas_call`` does in JAX's walker;
so does any other op.  The emitted op set is the one both graph executors
interpret (``adas_tpu/engine/onnx_engine.py`` and the port's
``engine/onnx_engine.py``).

Layout: the port computes NCHW, so the exported graph takes the NCHW f32
input the reference's exports take with no Transpose sandwiches; files
differ from JAX's node for node but not in input and output names, shapes
or numbers.

CLI (JAX's, plus ``--device``, default ``cuda``)::

    python -m adas_tpu_torch.tools.onnx_export --model ufldv2_culane \\
        [--weights w.npz] [--device cuda] -o model.onnx
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export.graph_signature import InputKind
from torch.utils import _pytree

from . import onnx_writer as W


class ExportError(NotImplementedError):
    pass


_ONNX_DTYPE = {
    torch.float32: 1, torch.bfloat16: 1, torch.float16: 10, torch.uint8: 2, torch.int8: 3,
    torch.int32: 6, torch.int64: 7, torch.bool: 9, torch.float64: 11,
}

_UNARY = {
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "exp": "Exp", "log": "Log",
    "sqrt": "Sqrt", "neg": "Neg", "abs": "Abs",
}
_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div"}
_IDENTITY = {"clone", "contiguous", "alias", "detach", "lift_fresh_copy"}
_RESHAPE = {"reshape", "view", "flatten", "unsqueeze", "squeeze", "_unsafe_view"}
_INT8_OPS = {"int8_conv", "fused_block"}


def _np_value(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.numpy())


class _Graph:
    """Accumulates ONNX nodes and initializers while walking the graph."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.names: Dict[str, str] = {}  # fx node name -> ONNX value name
        self.static: Dict[str, object] = {}  # fx node name -> export-time value
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint: str = "c") -> str:
        name = self.fresh(hint)
        self.inits[name] = _np_value(arr) if isinstance(arr, torch.Tensor) \
            else np.ascontiguousarray(arr)
        return name

    def node(self, op: str, ins: Sequence[str], **attrs) -> str:
        out = self.fresh(op.lower())
        self.nodes.append(W.make_node(op, list(ins), [out], **attrs))
        return out

    def value(self, arg, hint: str = "c") -> str:
        """The ONNX name of an fx argument: a traced value, or a static one
        (a parameter, a folded value, a Python number) as an initializer."""
        if isinstance(arg, torch.fx.Node):
            if arg.name in self.names:
                return self.names[arg.name]
            if arg.name in self.static:
                name = self.const(self.static[arg.name], hint)
                self.names[arg.name] = name
                return name
            raise ExportError(f"unbound graph value {arg.name}")
        return self.const(np.asarray(arg, np.float32), hint)


def _shape(node: torch.fx.Node) -> List[int]:
    return [int(d) for d in node.meta["val"].shape]


def _is_dynamic(g: _Graph, args) -> bool:
    found = []
    _pytree.tree_map(lambda a: found.append(a.name in g.names)
                     if isinstance(a, torch.fx.Node) else None, args)
    return any(found)


def _fold(g: _Graph, node: torch.fx.Node) -> None:
    """Evaluate a node of static inputs now (an initializer if used)."""
    def load(a):
        return g.static[a.name] if isinstance(a, torch.fx.Node) else a

    args = _pytree.tree_map(load, node.args)
    kwargs = _pytree.tree_map(load, dict(node.kwargs))
    with torch.no_grad():
        g.static[node.name] = node.target(*args, **kwargs)


def _stem(g: _Graph, node: torch.fx.Node) -> str:
    x, w, gain, bias, act, pool = node.args
    k = int(w.meta["val"].shape[-1])
    c = int(w.meta["val"].shape[0])
    y = g.node("Conv", [g.value(x), g.value(w, "w")], strides=[2, 2], pads=[k // 2] * 4,
               dilations=[1, 1], group=1)
    y = g.node("Mul", [y, g.const(_np_value(g.static[gain.name]).reshape(1, c, 1, 1), "gain")])
    y = g.node("Add", [y, g.const(_np_value(g.static[bias.name]).reshape(1, c, 1, 1), "bias")])
    y = _act(g, y, act)
    if pool:
        y = g.node("MaxPool", [y], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])
    return y


def _act(g: _Graph, y: str, act: Optional[str]) -> str:
    if act is None:
        return y
    if act == "relu":
        return g.node("Relu", [y])
    if act == "silu":
        return g.node("Mul", [y, g.node("Sigmoid", [y])])
    raise ExportError(f"stem activation {act!r} has no ONNX export mapping")


def _export_node(g: _Graph, node: torch.fx.Node) -> Optional[str]:
    """ONNX nodes for one call; returns the output's value name."""
    target = node.target
    ns = getattr(getattr(target, "_schema", None), "name", "") or ""
    name = getattr(target, "__name__", str(target)).split(".")[0]
    a = node.args
    if ns.startswith("adas_tpu_torch::"):
        op = ns.split("::", 1)[1]
        if op == "fused_stem":
            return _stem(g, node)
        raise ExportError(f"operator adas_tpu_torch::{op} has no ONNX export mapping")
    if name in _UNARY:
        return g.node(_UNARY[name], [g.value(a[0])])
    if name == "silu":
        x = g.value(a[0])
        return g.node("Mul", [x, g.node("Sigmoid", [x])])
    if name in _BINARY:
        if node.kwargs.get("alpha", 1) != 1 or node.kwargs.get("rounding_mode") is not None:
            raise ExportError(f"aten.{name} with {dict(node.kwargs)} has no ONNX export mapping")
        return g.node(_BINARY[name], [g.value(a[0]), g.value(a[1])])
    if name in _IDENTITY:
        return g.node("Identity", [g.value(a[0])])
    if name in _RESHAPE:
        return g.node("Reshape", [g.value(a[0]),
                                  g.const(np.asarray(_shape(node), np.int64), "shape")])
    if name in ("to", "_to_copy"):
        dtype = node.kwargs.get("dtype", a[1] if len(a) > 1 else None)
        if not isinstance(dtype, torch.dtype):
            return g.node("Identity", [g.value(a[0])])
        if dtype not in _ONNX_DTYPE:
            raise ExportError(f"no ONNX dtype for {dtype}")
        return g.node("Cast", [g.value(a[0])], to=_ONNX_DTYPE[dtype])
    if name == "conv2d":
        x, w = a[0], a[1]
        b = a[2] if len(a) > 2 else None
        stride, padding, dilation, groups = (list(a[3]) if len(a) > 3 else [1, 1],
                                             list(a[4]) if len(a) > 4 else [0, 0],
                                             list(a[5]) if len(a) > 5 else [1, 1],
                                             int(a[6]) if len(a) > 6 else 1)
        if isinstance(padding[0], str):
            raise ExportError(f"conv2d padding {padding!r} has no ONNX export mapping")
        ins = [g.value(x), g.value(w, "w")] + ([g.value(b, "b")] if b is not None else [])
        return g.node("Conv", ins, strides=stride, pads=padding * 2, dilations=dilation,
                      group=groups)
    if name == "batch_norm":
        x, w, b, mean, var, training, _, eps = a[:8]
        if training:
            raise ExportError("a BatchNorm in training mode has no ONNX form: export in eval mode")
        c = _shape(node)[1]
        w = g.value(w, "scale") if w is not None else g.const(np.ones(c, np.float32), "scale")
        b = g.value(b, "bias") if b is not None else g.const(np.zeros(c, np.float32), "bias")
        return g.node("BatchNormalization", [g.value(x), w, b, g.value(mean, "mean"),
                                             g.value(var, "var")], epsilon=float(eps))
    if name == "layer_norm":
        x, shape, w, b, eps = (list(a) + [None, None, 1e-5])[:5]
        ins = [g.value(x), g.value(w, "scale")] + ([g.value(b, "bias")] if b is not None else [])
        return g.node("LayerNormalization", ins, axis=-len(shape), epsilon=float(eps))
    if name == "linear":
        x, w = a[0], a[1]
        b = a[2] if len(a) > 2 else None
        if len(_shape(x)) == 2 and b is not None:
            return g.node("Gemm", [g.value(x), g.value(w, "w"), g.value(b, "b")], transB=1)
        wt = g.const(_np_value(g.static[w.name]).T.copy(), "w")
        y = g.node("MatMul", [g.value(x), wt])
        return g.node("Add", [y, g.value(b, "b")]) if b is not None else y
    if name == "max_pool2d":
        k = list(a[1])
        stride = list(a[2]) if len(a) > 2 and a[2] else k
        pad = list(a[3]) if len(a) > 3 else [0, 0]
        dil = list(a[4]) if len(a) > 4 else [1, 1]
        if (len(a) > 5 and a[5]) or dil != [1, 1]:
            raise ExportError("max_pool2d with ceil_mode or dilation has no ONNX export mapping")
        return g.node("MaxPool", [g.value(a[0])], kernel_shape=k, strides=stride, pads=pad * 2)
    if name == "upsample_nearest2d":
        sizes = g.const(np.asarray(_shape(node), np.int64), "sizes")
        return g.node("Resize", [g.value(a[0]), "", "", sizes], mode="nearest",
                      coordinate_transformation_mode="asymmetric", nearest_mode="floor")
    if name == "upsample_bilinear2d":
        sizes = g.const(np.asarray(_shape(node), np.int64), "sizes")
        mode = "align_corners" if a[2] else "half_pixel"
        return g.node("Resize", [g.value(a[0]), "", "", sizes], mode="linear",
                      coordinate_transformation_mode=mode)
    if name in ("softmax", "_softmax"):
        return g.node("Softmax", [g.value(a[0])], axis=int(a[1]))
    if name in ("sum", "mean"):
        dims = [int(d) for d in a[1]]
        keep = int(bool(a[2])) if len(a) > 2 else int(bool(node.kwargs.get("keepdim", False)))
        return g.node("ReduceSum" if name == "sum" else "ReduceMean", [g.value(a[0])],
                      axes=dims, keepdims=keep)
    if name == "cat":
        dim = int(a[1]) if len(a) > 1 else int(node.kwargs.get("dim", 0))
        return g.node("Concat", [g.value(t) for t in a[0]], axis=dim)
    if name == "slice":
        x, dim = a[0], int(a[1]) if len(a) > 1 else 0
        start = 0 if len(a) < 3 or a[2] is None else int(a[2])
        end = np.iinfo(np.int64).max if len(a) < 4 or a[3] is None else int(a[3])
        step = int(a[4]) if len(a) > 4 else 1
        consts = [g.const(np.asarray([v], np.int64), h)
                  for v, h in ((start, "starts"), (end, "ends"), (dim, "axes"), (step, "steps"))]
        return g.node("Slice", [g.value(x)] + consts)
    if name == "permute":
        return g.node("Transpose", [g.value(a[0])], perm=[int(p) for p in a[1]])
    if name == "expand":
        return g.node("Expand", [g.value(a[0]),
                                 g.const(np.asarray(_shape(node), np.int64), "shape")])
    raise ExportError(f"torch op '{target}' has no ONNX export mapping")


def export_fn_to_onnx(
    fn: Callable,
    example_args: Sequence[torch.Tensor],
    out_path: str,
    input_names: Optional[Sequence[str]] = None,
    output_names: Optional[Sequence[str]] = None,
    graph_name: str = "adas_tpu_torch",
) -> Dict[str, object]:
    """Trace ``fn(*example_args)`` and write an ONNX model
    (``onnx_export.py:417``).  ``fn`` is an inference-mode module or a
    function of tensors (the parameters of the modules it closes over
    become initializers); its outputs (a tensor, a tuple, or a dict in
    its order) are the graph's, in order.  Returns {"inputs", "outputs",
    "n_nodes", "n_initializers"}."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    module.eval()
    args = tuple(example_args)
    with torch.no_grad():
        module(*args)  # fill the caches the export lifts as constants
    ep = torch.export.export(module, args, strict=False)
    sig = ep.graph_signature
    g = _Graph()
    user = [s for s in sig.input_specs if s.kind == InputKind.USER_INPUT]
    input_names = list(input_names or [f"input_{i}" for i in range(len(user))])
    if len(input_names) != len(user):
        raise ValueError(f"{len(user)} traced inputs, {len(input_names)} names")
    inputs = []
    by_kind = {InputKind.PARAMETER: ep.state_dict, InputKind.BUFFER: ep.state_dict,
               InputKind.CONSTANT_TENSOR: ep.constants}
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            name = input_names[len(inputs)]
            g.names[spec.arg.name] = name
            t = args[len(inputs)]
            inputs.append(W.value_info(name, np.float32 if t.dtype == torch.bfloat16
                                       else _np_value(t[:0]).dtype, list(t.shape)))
        elif spec.kind in by_kind:
            g.static[spec.arg.name] = by_kind[spec.kind][spec.target]
        else:
            raise ExportError(f"graph input of kind {spec.kind} has no ONNX form")
    for node in ep.graph.nodes:
        op = getattr(getattr(node.target, "_schema", None), "name", "") or ""
        if op.split("::")[-1] in _INT8_OPS:
            raise ExportError(f"int8 operator {op} has no ONNX form (export the f32 net)")
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            continue
        if not _is_dynamic(g, (node.args, node.kwargs)):
            _fold(g, node)
            continue
        g.names[node.name] = _export_node(g, node)
    out_nodes = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    output_names = list(output_names or [f"output_{i}" for i in range(len(out_nodes))])
    if len(output_names) != len(out_nodes):
        raise ValueError(f"{len(out_nodes)} traced outputs, {len(output_names)} names")
    outputs = []
    for n, name in zip(out_nodes, output_names):
        g.nodes.append(W.make_node("Identity", [g.value(n)], [name]))
        val = n.meta["val"]
        outputs.append(W.value_info(name, np.float32 if val.dtype == torch.bfloat16
                                    else _np_value(torch.empty(0, dtype=val.dtype)).dtype,
                                    list(val.shape)))
    W.save_model(out_path, W.make_model(W.make_graph(g.nodes, graph_name, inputs, outputs,
                                                     g.inits)))
    return {"inputs": input_names, "outputs": output_names, "n_nodes": len(g.nodes),
            "n_initializers": len(g.inits)}


class _Fn(nn.Module):
    """A function as a module, its outputs flattened in order."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return tuple(_pytree.tree_leaves(self.fn(*args)))


def export_module_to_onnx(module: nn.Module, x: torch.Tensor, out_path: str,
                          input_names: Optional[Sequence[str]] = None,
                          output_names: Optional[Sequence[str]] = None,
                          graph_name: str = "adas_tpu_torch") -> Dict[str, object]:
    """:func:`export_fn_to_onnx` of ``module`` (in eval mode) on ``x``;
    a dict output is written in its key order."""
    return export_fn_to_onnx(module, [x], out_path, input_names, output_names, graph_name)


# ---- model builders for the CLI ----------------------------------------


def _build_export(model: str, weights: Optional[str], device="cuda"):
    """-> (fn(x_nchw), example NCHW input, output names)
    (``onnx_export.py:488``): the reference's export contracts: UFLD v1 ->
    one (1, grid+1, rows, 4) tensor ``output``; UFLD v2 ->
    ``loc_row``/``loc_col``/``exist_row``/``exist_col``; YOLOv8 ->
    ``output0`` (1, 84, 8400) at 640."""
    from ..models.ufld import UFLDV1_SPECS, UFLDV2_SPECS, UFLDv1Net, UFLDv2Net
    from ..models.yolo import YoloSpec, build_yolo
    from ..perception.object_detector import resolve_device
    from ..utils.types import LaneModelType

    device = resolve_device(device)
    model = model.lower()
    if model.startswith("ufldv2_"):
        spec = UFLDV2_SPECS[LaneModelType[f"UFLDV2_{model.split('_', 1)[1].upper()}"]]
        net = _load_or_init(UFLDv2Net(spec), weights, device)
        names = ["loc_row", "loc_col", "exist_row", "exist_col"]

        def fn(x):
            out = net(x)
            return tuple(out[k] for k in names)

        return fn, torch.zeros((1, 3, spec.input_height, spec.input_width), device=device), names
    if model.startswith("ufldv1_"):
        spec = UFLDV1_SPECS[LaneModelType[f"UFLD_{model.split('_', 1)[1].upper()}"]]
        net = _load_or_init(UFLDv1Net(spec), weights, device)
        return net, torch.zeros((1, 3, 288, 800), device=device), ["output"]
    if model.startswith("yolov8_"):
        spec = YoloSpec(scale=model.split("_", 1)[1], num_classes=80, input_size=(640, 640),
                        family="v8")
        net = _load_or_init(build_yolo(spec), weights, device)
        return net, torch.zeros((1, 3, 640, 640), device=device), ["output0"]
    raise SystemExit(f"unknown --model {model}")


def _load_or_init(net: nn.Module, weights: Optional[str], device) -> nn.Module:
    """The net on ``device`` in eval mode: the ``.npz`` variables store's
    weights (``params_io``'s flat flax tree, ``onnx_export.py:557``), or
    the seeded init (seed 0; other numbers than JAX's ``PRNGKey(0)``)."""
    from ..weights import init_params, load_flax_variables, load_npz

    net = net.to(device).eval()
    if weights:
        load_flax_variables(net, load_npz(weights))
    else:
        init_params(net, seed=0)
    return net


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export a built net to ONNX (reference-layout NCHW)")
    ap.add_argument("--model", required=True,
                    help="ufldv1_{tusimple,culane} | ufldv2_{tusimple,culane} | "
                         "yolov8_{n,s,m,l,x}")
    ap.add_argument("--weights", default=None, help=".npz variables store")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    fn, ex, names = _build_export(args.model, args.weights, args.device)
    info = export_fn_to_onnx(fn, [ex], args.output, input_names=["images"], output_names=names,
                             graph_name=args.model)
    print(f"wrote {args.output}: {info['n_nodes']} nodes, "
          f"{info['n_initializers']} initializers, outputs {names}")


if __name__ == "__main__":
    main()
