"""The port's model registry and its two weight CLIs against the JAX
package, on the CPU.

* ``engine/registry.py``: the same names as JAX's registry, and each
  entry's ``input_shape_nchw`` and metadata equal to JAX's (the nets
  built on the meta device: only their structure is made);
* ``python -m adas_tpu_torch.tools.torch_import`` and ``python -m
  adas_tpu_torch.tools.quantize``, run in a process that cannot import
  ``jax``, ``adas_tpu`` or ``cv2``, write archives that JAX's
  ``load_params`` and ``load_int8`` read back to the bit: equal to what
  JAX's importer and JAX's ``save_int8`` make of the same input;
* ``quantize --mode int8 --calibrate YOLOV8`` bakes an ``act_scales``
  leaf for every int8 conv and dense layer of the port's YOLOv8n (one
  N(0,1) frame here; the CLI's default is 8), the YOLO facade serves that
  ``_int8.npz`` calibrated, and ``--calib-dir`` of a directory without an
  image file stops as JAX's does (its calibration on real files:
  ``test_torch_lane_demo.py``).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from adas_tpu.engine import registry as jax_registry
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.tools import params_io as jax_params_io
from adas_tpu.tools import quantize as jax_quantize
from adas_tpu.tools import torch_import as jax_ti
from adas_tpu.tools.yolo_import import yolo_variables as jax_yolo_variables
from adas_tpu_torch.engine import registry
from adas_tpu_torch.models.quant import QConv2d, QLinear
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.tools import quantize
from adas_tpu_torch.tools.torch_import import ufld_state_dict
from adas_tpu_torch.tools.yolo_import import yolo_state_dict
from adas_tpu_torch.models.yolo import YoloSpec
from adas_tpu_torch.utils.types import ObjectModelType
from adas_tpu_torch.weights import flax_variables
from test_torch_models import SPEC_ARGS, random_flax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("adas_tpu", "jax", "jaxlib", "flax", "cv2")
RUN_BLOCKED = textwrap.dedent(
    """
    import json, runpy, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    for module, *args in json.loads(sys.argv[1]):
        sys.argv = [module, *args]
        runpy.run_module(module, run_name="__main__")
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    """
    % (BLOCKED, BLOCKED)
)


def run_cli(*calls):
    """Each (module, *args) call as ``python -m module args``, in turn, in
    one process that cannot import ``jax``, ``adas_tpu`` or ``cv2``."""
    calls = json.dumps([[str(a) for a in call] for call in calls])
    # one torch thread, as this process has (test_torch_models.py)
    return subprocess.run([sys.executable, "-c", RUN_BLOCKED, calls], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=300)


def assert_same_archive(got, want):
    got, want = (jax_params_io.flatten_variables(t) for t in (got, want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", jax_registry.available())
def test_registry_matches_jax(name):
    assert registry.available() == jax_registry.available()
    kwargs = [{}]
    if name.startswith("YOLO"):
        kwargs.append({"scale": "s", "height": 320, "width": 480, "num_classes": 20})
    elif name == "EFFICIENTDET":
        kwargs += [{"compound": 2}, {"scale": "1"}]
    for kw in kwargs:
        want = jax_registry.build(name, **kw)
        with torch.device("meta"):
            got = registry.build(name, **kw)
        assert got.input_shape_nchw == want.input_shape_nchw
        assert got.meta == want.meta
        assert type(got.net).__name__ == type(want.net).__name__
    with pytest.raises(KeyError, match="unknown model"):
        registry.build("YOLOV11")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Inputs for both CLIs (a seeded f32 YOLOv8n tree as a params_io
    ``.npz``; UFLDv2 and YOLOv8n ``.pth`` checkpoints under the released
    names, wrapped in ``{"model": ...}`` with ``module.`` prefixes), then
    every CLI call of the module's tests in one blocked process."""
    tmp = tmp_path_factory.mktemp("cli")
    yolo = random_flax_weights(JaxYoloV8(JaxYoloSpec("v8", "n", 80, (64, 64))), (1, 64, 64, 3),
                               seed=41)
    lane = random_flax_weights(JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)), (1, 64, 160, 3), seed=42)
    npz = str(tmp / "yolov8n.npz")
    jax_params_io.save_params(npz, jax_params_io.unflatten_variables(yolo))
    states = {"ufldv2": ufld_state_dict(lane),
              "yolov8": yolo_state_dict(yolo, YoloSpec("n", 80, family="v8"))}
    calls = []
    for arch, state in states.items():
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in state.items()}},
                   tmp / f"{arch}.pth")
        calls.append(("adas_tpu_torch.tools.torch_import", "-i", tmp / f"{arch}.pth", "-o",
                      tmp / f"{arch}.npz", "--arch", arch))
    calls += [("adas_tpu_torch.tools.quantize", "-i", npz, "-o", tmp / f"w_{mode}.npz",
               "--mode", mode) for mode in ("bf16", "int8")]
    calls.append(("adas_tpu_torch.tools.quantize", "-i", npz, "-o", tmp / "yolov8n_int8.npz",
                  "--mode", "int8", "--calibrate", "YOLOV8", "--scale", "n", "--calib-frames",
                  "1", "--device", "cpu"))
    proc = run_cli(*calls)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp, npz, proc.stdout


def test_torch_import_cli_matches_jax(cli):
    """``.pth`` -> ``.npz`` for UFLDv2 and YOLOv8n: the archive is what
    JAX's importer makes of the same checkpoint."""
    tmp, _, stdout = cli
    for arch in ("ufldv2", "yolov8"):
        pth, out = tmp / f"{arch}.pth", tmp / f"{arch}.npz"
        assert f"saved {out}" in stdout
        loaded = jax_ti.load_state_dict(str(pth))
        want = (jax_ti.ufld_variables(loaded) if arch == "ufldv2" else
                jax_yolo_variables(loaded, JaxYoloSpec("v8", "n", 80)))
        assert_same_archive(jax_params_io.load_params(str(out)), want)


def test_quantize_cli_casts_and_int8_match_jax(cli):
    """``--mode bf16`` writes JAX's bytes; ``--mode int8`` (no calibration)
    writes the store JAX's ``save_int8`` writes; ``--calib-dir`` of a
    directory with no image file stops with JAX's message."""
    tmp, npz, _ = cli
    tree = jax_params_io.load_params(npz)
    for mode in ("bf16", "int8"):
        out = tmp / f"w_{mode}.npz"
        ref = tmp / f"jax_{mode}.npz"
        if mode == "bf16":
            jax_params_io.save_params(str(ref), jax_quantize.cast_params(tree, mode))
        else:
            jax_quantize.save_int8(str(ref), tree)
            assert_same_archive(jax_quantize.load_int8(str(out)),
                                jax_quantize.load_int8(str(ref)))
        with np.load(out) as a, np.load(ref) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(a[k].tobytes() == b[k].tobytes() for k in b.files)
    with pytest.raises(SystemExit, match="no image files"):
        quantize.main(["-i", npz, "--mode", "int8", "--calibrate", "YOLOV8",
                       "--calib-dir", str(tmp), "--device", "cpu"])


def test_quantize_calibrate_bakes_every_int8_conv(cli):
    tmp, _, stdout = cli
    out = tmp / "yolov8n_int8.npz"
    assert "WARNING: calibrating on synthetic N(0,1) frames" in stdout
    store = jax_quantize.load_int8(str(out))
    assert_same_archive(quantize.load_int8(str(out)), store)
    scales = jax_params_io.flatten_variables({"act_scales": store["act_scales"]})
    net = registry.build("YOLOV8", int8=True).net
    int8 = [p for p, m in net.named_modules() if isinstance(m, (QConv2d, QLinear))]
    assert int8 and all(f"act_scales::{p.replace('.', '::')}::xmax" in scales for p in int8)
    assert all(np.isfinite(v).all() and (v > 0).all() for v in scales.values())
    # the facade serves the store calibrated: its scales are the store's
    yolo = YoloDetector(model_path=str(out), model_type=ObjectModelType.YOLOV8, scale="n",
                        compute_dtype="int8", device="cpu")
    served = {k: v for k, v in flax_variables(yolo.net).items() if k.startswith("act_scales::")}
    assert sorted(served) == sorted(scales)
    assert all(np.array_equal(served[k], scales[k]) for k in scales)
