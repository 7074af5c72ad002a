"""Multi-stream ADAS: N video feeds through ONE batched device step (port of
``MultiStreamADAS``, ``adas_tpu/pipeline/multistream.py:105``), on one
device or data-parallel over a (data, model) mesh of devices.

Per tick: the host prepares each BGR frame for its transport and uploads
the batch: ``"bgr"`` (JAX's default) uploads the frames as they are,
``"i420"`` encodes each to its 4:2:0 planes first (half the bytes); with
``host_downscale`` (H, W) each frame is resized on the host first
(``render/draw.resize_linear``, cv2's ``INTER_LINEAR``), whenever that
size is not the frame's, and the device sees frames of that size
(``dev_hw``).  One device step runs the preprocess, the YOLO net + decode
+ NMS (or a YOLOv10's one-to-one head and its top-k with ``nms_free``,
``multistream.py:311-316``) + letterbox inverse and UFLDv2 + lane decode
for all streams at once (the JAX step's ``vmap`` over streams is the
batch dimension here: an uncalibrated int8 net quantizes each stream at
its own dynamic scale, ``models/quant.dynamic_scale``) and packs the
results into one tensor; the host fetches it in one copy, scales the
detections from ``dev_hw`` back to the frame, and runs ByteTrack,
distance and TaskConditions per stream.  All cross-frame state is
host-side per stream.  On I420 the YUV-direct preprocess serves a YOLOv8
or v10, whose JAX stems take its planes; for the other YOLO families and
EfficientDet the step decodes the I420 batch into rounded BGR planes once
and feeds both nets from them (``multistream.py:257-285``; the net's
``stem_takes_planes`` decides).  Under int8 (both facades with
``compute_dtype="int8"``) the YOLO net takes bf16 input, the lane net bf16
on I420 and f32 on BGR (``multistream.py:190-205``, ``:344-348``).  The
object side may be an ``EfficientdetDetector`` (``multistream.py:164-181,
271-310``): the step letterboxes its frames square and
ImageNet-normalizes them, runs ``select_and_nms`` on the class
max/argmax, and feeds the lane net from the same frames.
:meth:`MultiStreamADAS.make_compute_probe` is the JAX bench's compute
probe (chained steps on a device-resident batch).
:meth:`MultiStreamADAS.export_fused` writes the whole device step (both
nets' weights, the preprocess, the decode and the NMS) as one ``.adas``
file (``multistream.py:582-616``), and ``step_artifact=`` serves a
pipeline from such a file: the facades then give only the host-side
helpers (class names, colours, the lane point assembly).  A YOLO facade
that an ONNX graph serves (``model_path="x.onnx"`` through
``engine/onnx_engine.OnnxGraphEngine``) takes part in the same step: the
executor's device prefix stands in for the net (``_ExecutorNet``,
``multistream.py:61-102``).

On a ``mesh`` (``parallel/mesh.py``) the streams are split over its
``data`` rows (``multistream.py:367-381``): each row holds a replica of
both nets on its first device (the parameters are replicated over
``model``, as JAX's ``repl`` replicates them; the row's other devices
would compute the same streams, so the port leaves them out, as JAX's
fetch dedupes them), the host prep uploads each row's frames to its
device, the rows' steps, each with every kernel of the single-device
step, are issued in turn under their devices (``parallel/mesh.in_turn``),
and the fetch copies each row's packed output back in stream order.
Each stream's image goes through the same operations as on one device.
Served eagerly, a mesh is slower than one card: each row's issue costs
the host about what the whole unsharded step's does (``parallel/mesh.py``
gives the measured ticks); the compute probe's CUDA graph per row is the
one path on which the cards run at once.
"""
from __future__ import annotations

import copy
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..tracking import BYTETracker
from ..utils.types import LaneInfo

from ..analytics import PerspectiveTransformation, SingleCamDistanceMeasure, TaskConditions
from ..ops.packing import unpack
from ..ops.preprocess import bgr_to_i420
from ..parallel.mesh import Mesh, device_scope, in_turn, sum_to
from ..parallel.sharding import batch_part, replicate
from ..render.draw import resize_linear
from .fused import fused_step, letterbox_geometry


class StreamState:
    """Host-side temporal state for one video feed (``multistream.py:52``)."""

    def __init__(self, frame_size, colors_dict, device):
        self.tracker = BYTETracker(names=dict(colors_dict))
        self.distance = SingleCamDistanceMeasure()
        self.conditions = TaskConditions()
        self.perspective = PerspectiveTransformation(frame_size, device=device)
        self.lane_info = LaneInfo()


class _ExecutorNet:
    """An ONNX graph executor (``engine/onnx_engine.OnnxGraphEngine``)
    presented as the YOLO net of the fused step (``multistream.py:61-102``):
    the preprocessed NCHW batch goes in as it is (cast to the graph's input
    type), the graph's first output comes out, on the device, with no host
    copy; a graph exported at batch 1 (``tools/onnx_export`` writes its
    Reshape and Expand shapes with the traced batch) runs once per
    stream.  The graph's device prefix must be the whole graph: a host tail
    (NonMaxSuppression/NonZero) cannot run inside the step.  It takes no
    I420 planes (JAX's ``stem_s2d_ok = False``): an I420 tick feeds it the
    decoded BGR planes."""

    stem_takes_planes = False

    def __init__(self, engine):
        from ..engine.onnx_engine import OnnxGraphEngine
        from ..engine.torch_engine import torch_dtype

        if not isinstance(engine, OnnxGraphEngine):
            raise TypeError(
                "fused serving of an engine-backed detector requires an "
                f"OnnxGraphEngine, got {type(engine).__name__}"
            )
        if engine._tail:
            raise ValueError(
                "ONNX graph has a dynamic host tail (NonMaxSuppression/NonZero) — it cannot "
                "serve inside the fused device step; re-export without the embedded NMS"
            )
        self.engine = engine
        self.dtype = torch_dtype(engine.engine_dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        n = self.engine.get_engine_input_shape()[0]
        if x.shape[0] == n:
            return self.engine.run_device(x)[0]
        if n != 1:
            raise ValueError(f"a graph of batch {n} serves batches of {n} or, one frame at a "
                             f"time, of any size; got {x.shape[0]}")
        # a batch-1 export (the reference's contract) runs once per stream
        return torch.cat([self.engine.run_device(x[i:i + 1])[0] for i in range(x.shape[0])])


class MultiStreamADAS:
    """Batch-of-streams pipeline on one device or over a (data, model)
    mesh; ``yolo`` is the object side, a ``YoloDetector`` or an
    ``EfficientdetDetector``.  The parameters are JAX's, in its order and
    with its defaults: ``mesh`` (a ``parallel.Mesh``, ``make_mesh``) splits
    the streams over its data rows, which must divide ``n_streams``
    (module doc); ``host_downscale`` (H, W) resizes each frame on the
    host, ``transport`` is ``"bgr"`` or ``"i420"``, and ``step_artifact``
    names a ``.adas`` file of :meth:`export_fused` to serve the device
    step from (its streams, ``dev_hw`` and transport must be this
    pipeline's; every weight comes from the file; on a mesh it serves the
    whole batch on the mesh's first device, as JAX's single-device
    artifact does)."""

    def __init__(
        self,
        yolo,
        lane,
        n_streams: int,
        frame_hw: Sequence[int],
        mesh=None,
        host_downscale: Optional[Sequence[int]] = None,
        transport: str = "bgr",
        step_artifact: Optional[str] = None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be an adas_tpu_torch.parallel.Mesh (make_mesh), got "
                             f"{type(mesh).__name__}")
        if mesh is not None and n_streams % mesh.axis_size("data"):
            raise ValueError(f"{n_streams} streams do not split evenly over the mesh's "
                             f"{mesh.axis_size('data')} data rows")
        if transport not in ("bgr", "i420"):
            raise ValueError(f"transport must be 'bgr' or 'i420', got {transport!r}")
        if yolo.device != lane.device:
            raise ValueError(f"detectors on {yolo.device} and {lane.device}")
        self.yolo = yolo
        self.lane = lane
        self.n_streams = n_streams
        self.frame_hw = tuple(frame_hw)
        self.host_downscale = tuple(host_downscale) if host_downscale else None
        self.transport = transport
        self.dev_hw = self.host_downscale or self.frame_hw
        self.mesh = mesh
        self.device = yolo.device if mesh is None else mesh.devices[0, 0]
        if step_artifact is None and getattr(yolo, "engine", None) is not None \
                and getattr(yolo, "net", None) is None:
            # an engine-served facade: its ONNX graph is the step's net
            # (JAX sets ``yolo.net`` the same way, ``multistream.py:161-174``)
            yolo.net = _ExecutorNet(yolo.engine)
        h, w = self.frame_hw
        self.geom = letterbox_geometry(yolo, self.dev_hw)
        self.streams = [StreamState((w, h), yolo.colors_dict, self.device) for _ in range(n_streams)]
        # calcCurveAndOffset reads only the canvas shape
        self._canvas = np.zeros((h, w, 3), np.uint8)
        self._pack_spec = None
        self._pool_lock = threading.Lock()
        self._prep_pool = None
        self._uploader = None
        self._fetcher = None
        self._step_engine = None
        # the nets each data row serves, and on a mesh the rows' devices
        self._views = [(yolo, lane)]
        self._rows = None
        if step_artifact is not None:
            self._load_step_artifact(step_artifact)
        elif mesh is not None:
            self._rows = mesh.row_devices()
            self._views = [(_row_view(yolo, d), _row_view(lane, d)) for d in self._rows]

    # ---- device step ----

    def _step(self, x):
        """(B, H*3/2, W) uint8 I420 or (B, H, W, 3) uint8 BGR frames of
        ``dev_hw`` on the device -> (B, total) f32 packed detections (in
        ``dev_hw`` pixels) + decoded lanes (``multistream.py:248-362``),
        through the fused step of ``pipeline/fused.py``, or the artifact's
        program of that step.  On a mesh ``x`` is the list of the rows'
        parts, each on its row's device, and so is the result."""
        if self._step_engine is not None:
            return self._step_engine.run_device(x)
        if self._rows is not None:
            return in_turn(self._rows, self._row_step, x)
        return self._row_step(0, x)

    def _row_step(self, r: int, x: torch.Tensor) -> torch.Tensor:
        """Data row ``r``'s step on its part of the batch, through its
        nets (the facades' own without a mesh, else the row's replicas)."""
        yolo, lane = self._views[r]
        flat, self._pack_spec = fused_step(yolo, lane, x, self.dev_hw, self.transport,
                                           nms_free=bool(getattr(self.yolo, "nms_free", False)))
        return flat

    def _transport_input_shape(self):
        """The device input's shape of one tick after the host prep."""
        h, w = self.dev_hw
        if self.transport == "i420":
            return (self.n_streams, h * 3 // 2, w)
        return (self.n_streams, h, w, 3)

    def export_fused(self, out_path: str, platforms=None) -> dict:
        """Write the whole pipeline's device work as one ``.adas`` file
        (``multistream.py:582-616``): the uint8 transport batch of all N
        streams in, the packed detections and lanes out, with both nets'
        weights, the preprocess, the decode and the NMS in one exported
        program (``engine/artifact.build_step_artifact``).  ``platforms``
        is this pipeline's device type (the default).  Serve it with
        ``MultiStreamADAS(..., step_artifact=out_path)``.  Returns the
        metadata written."""
        from ..engine.artifact import build_step_artifact, pack_tree_meta

        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError(
                "multi-device steps serialize device assignments; export from a single-device "
                "pipeline (the artifact is the per-chip deploy unit)"
            )
        if self._step_engine is not None:
            raise ValueError("export_fused needs the native step; this pipeline serves a "
                             "step_artifact")
        shape = self._transport_input_shape()
        # one step records the pack spec (the export runs another); on a
        # one-device mesh the step is its one row's
        self._row_step(0, torch.zeros(shape, dtype=torch.uint8, device=self.device))
        return build_step_artifact(
            lambda x: self._row_step(0, x), (shape, torch.uint8), out_path,
            platforms=[self.device.type] if platforms is None else platforms,
            device=self.device,
            meta={
                "kind": "multistream",
                "n_streams": self.n_streams,
                "frame_hw": list(self.frame_hw),
                "dev_hw": list(self.dev_hw),
                "transport": self.transport,
                **pack_tree_meta(self._pack_spec),
            },
        )

    def _load_step_artifact(self, path: str) -> None:
        """Serve the device step from a pipeline ``.adas`` file of
        :meth:`export_fused` (``multistream.py:618-641``), after checking
        the serving configuration against the baked one (read before the
        program is loaded)."""
        from ..engine.artifact import CompiledEngine, pack_spec_from_meta, read_meta

        m = read_meta(path)
        if m.get("kind") != "multistream":
            raise ValueError(f"{path} is not a multistream artifact")
        baked = (m["n_streams"], tuple(m["dev_hw"]), m["transport"])
        here = (self.n_streams, tuple(self.dev_hw), self.transport)
        if baked != here:
            raise ValueError(
                f"artifact was built for (streams, dev_hw, transport)={baked}, "
                f"pipeline configured {here}"
            )
        self._pack_spec = pack_spec_from_meta(m)
        self._step_engine = CompiledEngine(path, device=self.device)

    # ---- host orchestration ----

    def _host_prep(self, frames: np.ndarray) -> np.ndarray:
        """BGR (N, H, W, 3) uint8 -> the transport's batch
        (``multistream.py:388-415``): each frame resized to
        ``host_downscale`` when that is not the frame's size (as JAX does,
        also when it enlarges), then I420-encoded on the ``"i420"``
        transport; fanned out over a small thread pool (the resize and
        numpy's big array ops release the GIL).  BGR frames that need
        neither pass through."""
        resize = self.host_downscale is not None and self.host_downscale != self.frame_hw

        def prep_one(f):
            if resize:
                f = resize_linear(f, self.host_downscale[::-1])
            return bgr_to_i420(f) if self.transport == "i420" else f

        if self.transport != "i420" and not resize:
            return frames
        with self._pool_lock:  # several upload workers may get here first together
            if self._prep_pool is None:
                self._prep_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="adas-prep")
        return np.stack(list(self._prep_pool.map(prep_one, frames)))

    def _prep_upload(self, frames: np.ndarray):
        """Host prep + upload; returns the device-resident input batch, on a
        mesh the list of the rows' parts, each uploaded to its row's
        device (``multistream.py:421-425``)."""
        if frames.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} frames, got {frames.shape[0]}")
        host = np.ascontiguousarray(self._host_prep(frames))
        if self._rows is None:
            return torch.from_numpy(host).to(self.device)
        return [torch.from_numpy(batch_part(self.mesh, host, r)).to(d)
                for r, d in enumerate(self._rows)]

    def prefetch(self, frames: np.ndarray):
        """Host prep + upload on a background thread; returns a Future
        whose result goes to :meth:`submit_device`."""
        if self._uploader is None:
            self._uploader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="adas-upload")
        return self._uploader.submit(self._prep_upload, frames)

    def submit_device(self, x):
        """Launch the device step on an uploaded batch (asynchronous on a
        GPU: the returned tensor, or on a mesh the rows' tensors, is ready
        when :meth:`fetch` copies it)."""
        return self._step(x)

    def submit(self, frames: np.ndarray):
        """frames: (n_streams, H, W, 3) uint8 BGR."""
        return self._step(self._prep_upload(frames))

    def fetch(self, handle, frames: np.ndarray) -> List[dict]:
        """One device->host copy of the packed outputs (on a mesh one per
        row, in stream order: ``multistream.py:456-468``), then per-stream
        host analytics; returns the signal dicts."""
        if isinstance(handle, list):
            flat = np.concatenate([h.cpu().numpy() for h in handle])
        else:
            flat = handle.cpu().numpy()
        return self._analytics(flat, frames)

    def _analytics(self, flat: np.ndarray, frames: np.ndarray) -> List[dict]:
        """Host analytics per stream (``multistream.py:470-545``); the
        detections are scaled from ``dev_hw`` to the frame's pixels."""
        h, w = self.frame_hw
        sy, sx = h / self.dev_hw[0], w / self.dev_hw[1]
        results = []
        for i, stream in enumerate(self.streams):
            dets, lanes_i = unpack(flat[i], self._pack_spec)
            if (sy, sx) != (1.0, 1.0):
                dets = np.asarray(dets).copy()
                dets[:, [0, 2]] *= sx
                dets[:, [1, 3]] *= sy
            objs = self.yolo._dets_to_rectinfo(dets)
            # point the (stateless-compute) lane facade at THIS stream's
            # holder so geometry never bleeds across feeds
            self.lane.lane_info = stream.lane_info
            self.lane._assemble({k: v[0] for k, v in lanes_i.items()}, w, h)
            self.lane._finalize(h)
            lane_info = stream.lane_info

            boxes = [o.tolist(format_type="xyxy") for o in objs]
            stream.tracker.update(
                np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
                np.asarray([o.conf for o in objs], dtype=np.float64),
                [o.label for o in objs],
                frames[i],
            )
            stream.distance.updateDistance(objs)
            collision_pt = stream.distance.calcCollisionPoint(lane_info.area_points)
            if stream.conditions.CheckStatus() and lane_info.area_status:
                stream.perspective.updateTransformParams(
                    *lane_info.lanes_points[1:3], stream.conditions.transform_status,
                )
            bird_lanes = [
                stream.perspective.transformToBirdViewPoints(p)
                for p in lane_info.lanes_points
            ]
            (direction, curvature), offset = stream.perspective.calcCurveAndOffset(
                self._canvas, *bird_lanes[1:3], draw=False
            )
            stream.conditions.UpdateCollisionStatus(collision_pt, lane_info.area_status)
            stream.conditions.UpdateOffsetStatus(offset)
            stream.conditions.UpdateRouteStatus(direction, curvature)
            results.append(
                {
                    "objects": objs,
                    "tracks": len(stream.tracker.tracked_stracks),
                    "collision": stream.conditions.collision_msg,
                    "offset": stream.conditions.offset_msg,
                    "curvature": stream.conditions.curvature_msg,
                    "lane_info": lane_info,
                    "lanes_points": lane_info.lanes_points,
                    "lanes_status": lane_info.lanes_status,
                    "area_status": lane_info.area_status,
                }
            )
        return results

    def make_compute_probe(self, iters: int):
        """The JAX bench's compute probe (``multistream.py:547-570``): a
        callable ``probe(x)`` that runs the batched step ``iters`` times
        chained on the device-resident uploaded batch ``x`` (what
        :meth:`prefetch` returns) and returns a 0-d f32 tensor.  Step
        ``i`` takes ``x + i`` (uint8 wraparound, as JAX adds the loop
        index) and adds its packed output's sum into the carry, so no step
        can be skipped or hoisted.

        On a GPU the first call runs one eager step (the kernels' plans and
        maps), then captures all ``iters`` steps in ONE CUDA graph on a
        copy of ``x`` that the probe owns; every call (the first too)
        copies ``x`` into that buffer and replays the graph once, so the
        host's launches are not timed.  The kernels' launch counters count
        the captured launches once, at capture, and no replay.  A capture
        that fails raises (no eager fallback).  On the CPU the probe runs
        the steps as a plain loop.  A pipeline served from a
        ``step_artifact`` has no native step to chain: it raises, as JAX's
        does.

        On a mesh ``x`` is the rows' parts (what :meth:`prefetch` returns):
        each row's chain is captured in a CUDA graph of its own, on its
        device, and every call replays them all; the result is the sum of
        the rows' carries."""
        if self._step_engine is not None:
            raise RuntimeError("compute probe needs the native graph; this pipeline serves a "
                               "pre-serialized step_artifact")
        def chained(r: int, x: torch.Tensor) -> torch.Tensor:
            s = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(iters):
                s = s + self._row_step(r, x + (i % 256)).sum()
            return s

        graphs = []

        def capture(r: int, x: torch.Tensor) -> dict:
            self._row_step(r, x)  # eager warm-up: plans, maps, the pack spec
            static = x.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side), torch.cuda.graph(g, stream=side):
                out = chained(r, static)
            torch.cuda.current_stream(x.device).wait_stream(side)
            return {"g": g, "x": static, "out": out}

        @torch.inference_mode()
        def probe(x) -> torch.Tensor:
            parts = x if isinstance(x, list) else [x]
            if parts[0].device.type != "cuda":
                return sum_to([chained(r, p) for r, p in enumerate(parts)], parts[0].device)
            if not graphs:
                for r, p in enumerate(parts):
                    with device_scope(p.device):
                        graphs.append(capture(r, p))
            for p, graph in zip(parts, graphs):
                with device_scope(p.device):
                    graph["x"].copy_(p)
                    graph["g"].replay()
            return sum_to([graph["out"] for graph in graphs], parts[0].device).clone()

        return probe

    def process_batch(self, frames: np.ndarray) -> List[dict]:
        return self.fetch(self.submit(frames), frames)

    def serve_pipelined(self, batches, depth: int = 3, on_result=None,
                        upload_workers: int = 1) -> int:
        """Three-stage software pipeline over a tick iterator
        (``multistream.py:642-707``): stage 1 (upload thread(s)) host prep
        + upload, stage 2 (caller thread) launches the device step, stage 3
        (fetch thread) copies the packed outputs back and runs the
        per-stream analytics, IN ORDER on one worker so tracker and
        condition state advance in tick order.

        ``batches``: iterable of (n_streams, H, W, 3) uint8 ticks.
        ``depth``: max un-fetched device batches.
        ``on_result(tick_index, signals)``: optional, called on the fetch
        thread in order.  ``upload_workers``: more than 1 creates the
        uploader pool with that many threads (when none exists yet, as
        JAX does); the steps still launch in tick order.  Returns the
        number of ticks."""
        if self._fetcher is None:
            self._fetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="adas-fetch")
        if upload_workers > 1 and self._uploader is None:
            self._uploader = ThreadPoolExecutor(max_workers=int(upload_workers),
                                                thread_name_prefix="adas-upload")

        def fetch_and_report(idx, handle, frames):
            out = self.fetch(handle, frames)
            if on_result is not None:
                on_result(idx, out)

        pending = deque()  # (idx, frames, Future[device batch])
        fetches = deque()  # Futures from the fetch worker
        n = 0
        for idx, frames in enumerate(batches):
            n = idx + 1
            pending.append((idx, frames, self.prefetch(frames)))
            if len(pending) >= 2:
                i, f, fut = pending.popleft()
                h = self.submit_device(fut.result())
                fetches.append(self._fetcher.submit(fetch_and_report, i, h, f))
            while len(fetches) > depth:
                fetches.popleft().result()
        while pending:
            i, f, fut = pending.popleft()
            h = self.submit_device(fut.result())
            fetches.append(self._fetcher.submit(fetch_and_report, i, h, f))
        while fetches:
            fetches.popleft().result()
        return n

    def close(self) -> None:
        """Stop the pipeline's worker threads."""
        for pool in (self._prep_pool, self._uploader, self._fetcher):
            if pool is not None:
                pool.shutdown(wait=True)
        self._prep_pool = self._uploader = self._fetcher = None


def _row_view(facade, device: torch.device):
    """A facade as ``fused_step`` sees it, for one data row: a shallow copy
    whose net is a replica on ``device`` (an ONNX graph executor a new
    executor of the same graph there)."""
    view = copy.copy(facade)
    net = facade.net
    if isinstance(net, _ExecutorNet):
        from ..engine.onnx_engine import OnnxGraphEngine

        engine = OnnxGraphEngine(net.engine._model, batch_size=net.engine.get_engine_input_shape()[0],
                                 device=device)
        view.engine = engine
        view.net = _ExecutorNet(engine)
    else:
        view.net = replicate(net, device)
    view.device = device
    return view
