"""The port's mesh, sharding rules and sharded stream step
(``adas_tpu_torch/parallel/{mesh,sharding,streams}.py``) against the JAX
package's (``adas_tpu/parallel``), on CPU meshes that repeat one device
(JAX's tests run 8 virtual CPU devices, ``tests/conftest.py``).

Mesh shapes against JAX's ``make_mesh(n).devices.shape`` for n = 1..8 and
its errors; ``tp_param_spec`` against JAX's for every leaf of a small
UFLDv2 tree, f32 and packed, calibrated int8, through the weight bridge's
names (a 2-D flax kernel is the transpose of the torch weight, so its
spec is the transpose of JAX's); the batch and head splits against JAX's
``NamedSharding`` indices.  One JAX mesh run: JAX's
``make_sharded_stream_step`` of a UFLDv2 forward on ``make_mesh(8)``
(data 4, model 2: the head split over ``model``) against the port's on a
(4, 2) CPU mesh, within ``test_torch_models``'s tolerance (rtol 1e-3,
atol 1e-3 of the output's largest magnitude), and the port's against its
own unsharded forward within 1e-6 relative L2 (f32: the split head sums
``cls_fc2`` in two halves).  An int8 head split over ``model`` equals
the unsharded one to the bit (the s32 partials are summed before the
dequant).  The UFLDv2 is ``tests/test_torch_train.py``'s 64x128 spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.parallel import make_mesh as jax_make_mesh
from adas_tpu.parallel import make_sharded_stream_step as jax_sharded_step
from adas_tpu.parallel.sharding import tp_param_spec as jax_tp_param_spec
from adas_tpu_torch.models.quant import pack_int8_weights
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.parallel import (
    Mesh,
    MeshReplicas,
    PartitionSpec as P,
    batch_sharding,
    make_mesh,
    make_sharded_stream_step,
    param_shardings,
    replicated_sharding,
    shard_ufld_params,
    tp_param_spec,
)
from adas_tpu_torch.parallel.mesh import mesh_shape
from adas_tpu_torch.parallel.sharding import NamedSharding, batch_part, replicate
from adas_tpu_torch.perception.object_detector import calibrate
from adas_tpu_torch.weights import flax_variables, load_flax_variables, state_dict_from_flax
from test_torch_models import _close, _unflatten, random_flax_weights
from test_torch_train import SPEC_ARGS


def cpu_mesh(n=8, model_parallel=None):
    return make_mesh(n, model_parallel, devices=["cpu"] * n)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_jax(n):
    assert mesh_shape(n, available=8) == jax_make_mesh(n).devices.shape
    mesh = cpu_mesh(n)
    assert mesh.devices.shape == jax_make_mesh(n).devices.shape
    assert mesh.axis_names == jax_make_mesh(n).axis_names == ("data", "model")
    assert dict(mesh.shape) == dict(jax_make_mesh(n).shape) and mesh.size == n
    assert mesh.repeats == (n > 1)


def test_mesh_rules_match_jax():
    """``model_parallel`` given, and JAX's two errors (too many devices, a
    ``model_parallel`` that does not divide the count)."""
    for n, mp in ((8, 1), (8, 4), (6, 3), (4, 4), (2, 2)):
        assert mesh_shape(n, mp, available=8) == jax_make_mesh(n, mp).devices.shape
    for args in ((9, None), (8, 3), (6, 4)):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(*args)
        with pytest.raises(ValueError) as got:
            mesh_shape(*args, available=8)
        assert str(got.value).split()[0] == str(want.value).split()[0]
    with pytest.raises(ValueError, match="only 8 present"):
        make_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Mesh([["cuda:0", "cuda:0"]])
    with pytest.raises(ValueError, match="2-D"):
        Mesh(["cpu", "cpu"])


class _Key:
    """Stands in for a flax path key (``jax.tree_util.DictKey``)."""

    def __init__(self, key):
        self.key = key


def jax_spec(flax_key: str):
    return jax_tp_param_spec(tuple(_Key(k) for k in flax_key.split("::")), None)


def port_names(flax_key: str, flat):
    """The port's names of a flax leaf, through the weight bridge."""
    one = {flax_key: flat[flax_key]}
    coll, *path, leaf = flax_key.split("::")
    if flax_key.endswith("::kernel") and np.asarray(flat[flax_key]).dtype == np.int8:
        wkey = "::".join(["wscales", *path, "wscale"])
        one[wkey] = flat[wkey]
        return [k for k in state_dict_from_flax(one) if not k.endswith("wscale")]
    return list(state_dict_from_flax(one))


def normal(spec):
    """``spec`` without its trailing Nones (``P("model", None)`` is
    ``P("model")``: a dimension past the spec is not split)."""
    axes = list(spec)
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def transposed(spec, ndim):
    axes = tuple(spec) + (None,) * (ndim - len(spec))
    return normal(axes[::-1] if ndim == 2 else axes)


def small_int8_net(flat):
    """The small UFLDv2 as an int8 net, packed and calibrated on two inputs."""
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS), int8=True).eval()
    load_flax_variables(net, {k: v for k, v in flat.items()})
    pack_int8_weights(net)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 64, 128)).astype(np.float32))
    with torch.no_grad():
        calibrate(net, [x[:1], x[1:]])
    return net


@pytest.fixture(scope="module")
def flax_tree():
    jnet = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS))
    return jnet, random_flax_weights(jnet, (1, 64, 128, 3), seed=4)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_tp_param_spec_matches_jax(flax_tree, precision):
    """Every leaf's spec: JAX's on the flax tree, the port's on the names
    the bridge gives it, transposed where the bridge transposes."""
    flat = flax_tree[1]
    if precision == "int8":
        flat = flax_variables(small_int8_net(flat))
        assert any(k.startswith("act_scales::cls_fc2::") for k in flat)
        assert np.asarray(flat["params::cls_fc1::kernel"]).dtype == np.int8
    split = 0
    for key in flat:
        want = jax_spec(key)
        ndim = np.asarray(flat[key]).ndim
        for name in port_names(key, flat):
            assert normal(tp_param_spec(name)) == transposed(want, ndim), (key, name, want)
            assert tp_param_spec(tuple(name.split("."))) == tp_param_spec(name)
            split += "model" in tp_param_spec(name)
    # cls_fc1's kernel and bias and cls_fc2's kernel (+ wq under int8)
    assert split == (3 if precision == "f32" else 5)


def test_batch_and_head_splits_match_jax_indices():
    """The piece of every cell, against JAX's ``devices_indices_map`` on
    ``make_mesh(8)``; ``batch_part`` cuts each data row's part by it."""
    jmesh = jax_make_mesh(8)
    mesh = cpu_mesh(8)
    cases = [(batch_sharding(mesh, 4), JaxP("data", None, None, None), (8, 3, 4, 5)),
             (replicated_sharding(mesh), JaxP(), (6, 2)),
             (NamedSharding(mesh, P("model", None)), JaxP("model", None), (8, 6)),
             (NamedSharding(mesh, P(None, "model")), JaxP(None, "model"), (6, 8))]
    for sharding, jspec, shape in cases:
        want = JaxNamedSharding(jmesh, jspec).devices_indices_map(shape)
        for cell, dev in np.ndenumerate(jmesh.devices):
            got = sharding.index(shape, cell)
            assert tuple((s.start or 0, s.stop or n) for s, n in zip(got, shape)) == \
                tuple((s.start or 0, s.stop or n) for s, n in zip(want[dev], shape))
    x = torch.arange(8 * 3).reshape(8, 3)
    for r in range(4):
        assert torch.equal(batch_part(mesh, x, r), x[2 * r:2 * r + 2])
        assert np.array_equal(batch_part(mesh, x.numpy(), r), x.numpy()[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not split"):
        batch_part(mesh, torch.zeros(6, 3), 0)


@pytest.fixture(scope="module")
def port_net(flax_tree):
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS)).eval()
    load_flax_variables(net, flax_tree[1])
    return net


def images(seed=5, b=8):
    return np.random.default_rng(seed).normal(size=(b, 64, 128, 3)).astype(np.float32)


def test_sharded_stream_step_matches_jax(flax_tree, port_net):
    """JAX's sharded forward on ``make_mesh(8)`` and the port's on a (4, 2)
    mesh, and the port's against its unsharded forward."""
    jnet, flat = flax_tree
    x = images()
    jstep = jax_sharded_step(lambda v, f: jnet.apply(v, f), _unflatten(flat), jax_make_mesh(8))
    want = jax.device_get(jstep(jnp.asarray(x)))
    step = make_sharded_stream_step(lambda net, f: net(f), port_net, cpu_mesh(8))
    assert isinstance(step.replicas, MeshReplicas) and step.replicas.tp
    out = step(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(out) == 4 and all(o["loc_row"].shape[0] == 2 for o in out)
    with torch.no_grad():
        ref = port_net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in want:
        got = torch.cat([o[k] for o in out])
        _close(got.numpy(), np.asarray(want[k]))
        rel = float((got - ref[k]).norm() / ref[k].norm())
        assert rel < 1e-6, (k, rel)
    with pytest.raises(ValueError, match="does not split"):
        step(torch.zeros(6, 3, 64, 128))
    with pytest.raises(ValueError, match="4-d"):
        step(torch.zeros(8, 64, 128))


@pytest.mark.parametrize("calibrated", [False, True])
def test_int8_head_split_is_exact(flax_tree, calibrated):
    """The packed int8 head split over ``model`` (2 columns) equals the
    unsharded net to the bit, with static and with dynamic scales."""
    net = small_int8_net(flax_tree[1])
    if not calibrated:
        for m in (net.cls_fc1, net.cls_fc2):
            m.xmax = None
    x = torch.from_numpy(images(6, 4).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        ref = net(x)
    step = make_sharded_stream_step(lambda n, f: n(f), net, Mesh([["cpu", "cpu"]] * 2))
    out = step(x)
    head = step.replicas.replicas[0].mlp
    assert head.int8 and head.fc1[0].wq.shape == (SPEC_ARGS["mlp_mid"] // 2, net.cls_fc1.in_features)
    assert (getattr(head.rep2, "xmax", None) is not None) == calibrated
    for k in ref:
        assert torch.equal(torch.cat([o[k] for o in out]), ref[k]), k


def test_placement_round_trips(port_net):
    """``shard_ufld_params`` keeps the whole net: gathered leaves equal the
    net's, scattered ones land in every replica's shards, the shards
    are the spec's pieces, and every leaf has a sharding."""
    mesh = cpu_mesh(8)
    placed = shard_ufld_params(port_net, mesh)
    whole = dict(port_net.state_dict())
    got = placed.gather()
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert torch.equal(got[k], v), k
    rep = placed.replicas[3]
    assert not hasattr(rep, "cls_fc1") and rep.mlp.fc1[1].weight.shape == (32, 64)
    assert torch.equal(rep.mlp.fc2[1].weight, port_net.cls_fc2.weight[:, 32:])
    doubled = {k: v * 2 for k, v in whole.items() if v.is_floating_point()}
    placed.scatter(doubled)
    for k, v in placed.gather(list(doubled)).items():
        assert torch.equal(v, doubled[k]), k
    shardings = param_shardings(port_net, mesh)
    assert set(shardings) == set(whole)
    assert shardings["cls_fc2.weight"] == NamedSharding(mesh, P(None, "model"))


def test_replicas_build_their_own_caches(flax_tree):
    """A replica drops the source's derived-tensor caches (the packed
    kernel weights, the BN folds) and builds its own at its first call."""
    net = small_int8_net(flax_tree[1])
    x = torch.from_numpy(images(7, 1).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        want = net(x)
    cached = [m for m in net.modules() if m.__dict__.get("_int8_cache")]
    assert cached
    rep = replicate(net, torch.device("cpu"))
    assert not any(m.__dict__.get("_int8_cache") for m in rep.modules())
    with torch.no_grad():
        got = rep(x)
    source = {id(t) for m in cached for t in m.__dict__["_int8_cache"].values()
              if isinstance(t, torch.Tensor)}
    mine = {id(t) for m in rep.modules() for t in m.__dict__.get("_int8_cache", {}).values()
            if isinstance(t, torch.Tensor)}
    assert mine and not mine & source
    for k in want:
        assert torch.equal(got[k], want[k])


def test_row_rendezvous_under_thread_switches():
    """The trainer's sum across rows (``train._RowSum``: a barrier, one
    autograd node per sum) from more row threads than cores, 100 sums
    each, the interpreter switching threads every microsecond: every row
    gets every sum whole, and the backward of a sum hands each row the
    sum of the rows' gradients."""
    import sys

    from adas_tpu_torch.parallel.mesh import RowThreads
    from adas_tpu_torch.parallel.train import _RowSum

    n, rounds = 12, 100
    rows = RowThreads([torch.device("cpu")] * n)
    stats = _RowSum(n)
    parts = [torch.full((2, 3), float(r + 1), requires_grad=True) for r in range(n)]

    def row(r, part):
        got = []
        for i in range(rounds):
            total, count = stats(r, part * (i + 1), 5)
            got.append((float(total[0, 0]), count))
        total, _ = stats(r, part, 5)
        return got, total

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = rows.run(row, parts)
    finally:
        sys.setswitchinterval(interval)
        rows.close()
    want = [(n * (n + 1) / 2 * (i + 1), 5 * n) for i in range(rounds)]
    assert all(got == want for got, _ in out)
    sum(total.sum() for _, total in out).backward()
    for p in parts:
        assert torch.equal(p.grad, torch.full((2, 3), float(n)))
