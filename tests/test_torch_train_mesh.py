"""The port's sharded UFLDv2 trainer (``adas_tpu_torch/parallel/train.py``
on a mesh) against JAX's 8-device GSPMD step (``adas_tpu/parallel/
train.py``) and against the port's own unsharded step, and its
checkpoints on a mesh (``parallel/checkpoint.py``).

The spec and batch of ``tests/test_parallel.py:49-61`` (UFLDv2, ResNet-18
trunk, 64x128, 16 cells, 8 rows and columns, a 64-wide MLP), batch 8, the
aux head on, SGD lr 0.02, momentum 0.9, from the port's seeded initial
tree.  One JAX run: its GSPMD train step on ``make_mesh(8)`` (data 4,
model 2) from that tree (through the weight bridge), placed with JAX's
own shardings, one step.  The port's state on a (4, 2) CPU mesh has one
replica per data row and the head split over ``model``.

Bounds: the first loss within rel 2e-5 of JAX's (``tests/test_parallel.py:83``).
In f64 (the nets cast to f64), 3 sharded steps equal 3 unsharded steps of the port
within 1e-6 of each leaf's largest move (``test_torch_train.py``'s
``MOVE_TOL``; the port's unsharded f64 steps are held to JAX's there):
params, BatchNorm running statistics and momentum; every replica's
running statistics equal to the bit.  A checkpoint round trip keeps the
splits (``tests/test_parallel.py:86-118``), on a (2, 2) mesh: saved whole,
restored onto a fresh sharded state to the bit with each shard its piece, a resumed run
equal to the uninterrupted one, and a checkpoint of either kind restores
onto the other.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.parallel import make_mesh as jax_make_mesh
from adas_tpu.parallel import train as jax_train
from adas_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from adas_tpu.parallel.sharding import param_shardings
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu_torch.models.ufld import UFLDv2Spec
from adas_tpu_torch.parallel import (
    MeshReplicas,
    latest_checkpoint,
    make_mesh,
    make_ufld_train_state,
    make_ufld_train_step,
    restore_train_state,
    save_train_state,
    shard_ufld_params,
)
from adas_tpu_torch.weights import flax_variables
from test_torch_train import LR, MOVE_TOL, SPEC_ARGS, STEPS, displacement_error, make_batch, torch_batch

B = 8


def cpu_mesh(model_parallel=2, n=8):
    return make_mesh(n, model_parallel, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def base():
    """The port's seeded net in training mode (the initial tree)."""
    return make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), use_aux=True, device="cpu",
                                 generator=torch.Generator().manual_seed(0))[0]


@pytest.fixture(scope="module")
def jax_run(base):
    """JAX's sharded train step on ``make_mesh(8)`` from the port's initial
    tree, placed as ``make_ufld_train_state`` places its own
    (``train.py:76-85``: the params by ``param_shardings``, the momentum by
    ``_opt_shardings``, the batch statistics replicated): the first
    step's loss."""
    mesh = jax_make_mesh(8)
    tree = unflatten_variables(flax_variables(base))
    params, stats = tree["params"], tree["batch_stats"]
    tx = optax.sgd(LR, momentum=0.9)
    opt = tx.init(params)
    p_shard, repl = param_shardings(params, mesh), JaxNamedSharding(mesh, JaxP())
    state = {"params": jax.device_put(params, p_shard),
             "batch_stats": jax.device_put(stats, repl),
             "opt_state": jax.device_put(opt, jax_train._opt_shardings(opt, p_shard, repl))}
    assert state["params"]["cls_fc1"]["kernel"].sharding.spec == JaxP(None, "model")
    step = jax_train.make_ufld_train_step(
        JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS), use_aux=True), tx, mesh, state)
    batch = make_batch(1, b=B)
    jb = {k: jax.device_put(jnp.asarray(v), jax_batch_sharding(mesh, np.ndim(v)))
          for k, v in batch.items()}
    _, loss = step(state, jb)
    return {"batch": batch, "loss": float(loss)}


def port_state(base, mesh, dtype=torch.float32):
    """A train state on a copy of ``base``: unsharded (``mesh`` None) or
    placed on ``mesh`` as ``make_ufld_train_state`` places its net (the
    trainer's optimizer over the placed parameters)."""
    net = copy.deepcopy(base).to(dtype)
    if mesh is not None:
        net = shard_ufld_params(net, mesh)
    opt = torch.optim.SGD(net.parameters(), lr=LR, momentum=0.9, dampening=0.0)
    state = {"net": net, "optimizer": opt}
    return make_ufld_train_step(net, opt, mesh, state), state


def test_first_loss_matches_jax(jax_run, base):
    step, state = port_state(base, cpu_mesh())
    loss = float(step(state, torch_batch(jax_run["batch"]))[1])
    assert loss == pytest.approx(jax_run["loss"], rel=2e-5)


@pytest.fixture(scope="module")
def f64_runs(base):
    """3 steps in f64, sharded on (4, 2) and unsharded, from one tree."""
    batch = torch_batch(make_batch(1, b=B))
    batch["images"] = batch["images"].double()
    out = {}
    for name, mesh in (("sharded", cpu_mesh()), ("unsharded", None)):
        step, state = port_state(base, mesh, torch.float64)
        out[name] = (state, [float(step(state, batch)[1]) for _ in range(STEPS)])
    return out


def momentum(state, names):
    opt = state["optimizer"]
    net = state["net"]
    if isinstance(net, MeshReplicas):
        return net.gather(net.whole_params, of=lambda t: opt.state[t]["momentum_buffer"])
    by_id = {id(p): n for n, p in net.named_parameters()}
    return {by_id[id(p)]: s["momentum_buffer"] for p, s in opt.state.items()}


@pytest.mark.parametrize("coll", ["params", "batch_stats", "momentum"])
def test_sharded_steps_equal_unsharded(base, f64_runs, coll):
    """Every leaf after 3 f64 steps within ``MOVE_TOL`` of its move; the
    losses within 1e-12, and falling."""
    (sstate, slosses), (ustate, ulosses) = f64_runs["sharded"], f64_runs["unsharded"]
    np.testing.assert_allclose(slosses, ulosses, rtol=1e-12)
    assert slosses[-1] < slosses[0]
    unet = ustate["net"]
    init = {k: v.double() for k, v in base.state_dict().items()}
    if coll == "momentum":
        got, want = momentum(sstate, None), momentum(ustate, None)
        init = {k: torch.zeros_like(v) for k, v in want.items()}
    else:
        names = [k for k, _ in (unet.named_parameters() if coll == "params"
                                else unet.named_buffers())]
        got = sstate["net"].gather(names)
        want = {k: v for k, v in unet.state_dict().items() if k in names}
    assert set(got) == set(want) and want
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), k
            continue
        err = displacement_error(got[k].numpy(), v.numpy(), init[k].numpy())
        assert err < MOVE_TOL, (k, err)


def test_replicas_stay_equal(f64_runs):
    """The running statistics (and every parameter) of each replica equal
    row 0's to the bit: the BatchNorm took the whole batch's statistics
    and the gradients were summed across the rows."""
    net = f64_runs["sharded"][0]["net"]
    first = net.replicas[0].state_dict()
    assert any(k.endswith("running_var") for k in first)
    for rep in net.replicas[1:]:
        for k, v in rep.state_dict().items():
            assert torch.equal(v, first[k]), k


def test_step_rules():
    """A sharded state trains only with its mesh; a batch that does not
    split over the data rows raises; a mesh that is not a ``Mesh`` raises."""
    mesh = cpu_mesh()
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), mesh, use_aux=True)
    with pytest.raises(ValueError, match="mesh"):
        make_ufld_train_step(net, opt)
    with pytest.raises(ValueError, match="same mesh"):
        make_ufld_train_step(net, opt, cpu_mesh(1), state)
    with pytest.raises(ValueError, match="mesh"):
        make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), mesh=object(), device="cpu")
    step = make_ufld_train_step(net, opt, mesh, state)
    with pytest.raises(ValueError, match="does not split"):
        step(state, torch_batch(make_batch(2, b=6)))
    assert net.replicas[0].mlp.fc1[1].weight.shape[0] == SPEC_ARGS["mlp_mid"] // 2


def snapshot(state):
    net, opt = state["net"], state["optimizer"]
    out = {f"w:{k}": v for k, v in net.gather().items()}
    out.update({f"m:{k}": v for k, v in momentum(state, None).items()})
    return out


def test_checkpoint_round_trip_keeps_the_splits(base, tmp_path):
    """Saved whole after a step, restored onto a fresh sharded state: every
    leaf and momentum to the bit, each shard the spec's piece; the
    resumed step equals the uninterrupted one."""
    mesh = cpu_mesh(n=4)
    batch = torch_batch(make_batch(1, b=B))
    step, state = port_state(base, mesh)
    step(state, batch)
    target = save_train_state(str(tmp_path / "ckpt"), state, step=1)
    assert target == latest_checkpoint(str(tmp_path / "ckpt")) and target.endswith("step_00000001")
    saved = torch.load(f"{target}/state.pt", weights_only=True)
    assert saved["params"]["cls_fc1.weight"].shape == (SPEC_ARGS["mlp_mid"], 64)

    net2, opt2, fresh = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), mesh, learning_rate=LR,
                                              use_aux=True,
                                              generator=torch.Generator().manual_seed(8))
    restored, n = restore_train_state(target, fresh)
    assert n == 1 and restored is fresh
    want, got = snapshot(state), snapshot(fresh)
    assert set(got) == set(want) and any(k.startswith("m:") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    shard = net2.replicas[1].mlp.fc2[1].weight
    assert torch.equal(shard, saved["params"]["cls_fc2.weight"][:, SPEC_ARGS["mlp_mid"] // 2:])
    step2 = make_ufld_train_step(net2, opt2, mesh, fresh)
    assert float(step2(fresh, batch)[1]) == float(step(state, batch)[1])
    want, got = snapshot(state), snapshot(fresh)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_checkpoints_cross_between_mesh_and_none(base, tmp_path):
    """An unsharded checkpoint restores onto a mesh and a sharded one
    without a mesh, to the bit."""
    batch = torch_batch(make_batch(1, b=B))
    ustep, ustate = port_state(base, None)
    ustep(ustate, batch)
    target = save_train_state(str(tmp_path / "plain"), ustate, step=4)
    _, _, sharded = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), cpu_mesh(n=4), use_aux=True)
    restore_train_state(target, sharded)
    want = dict(ustate["net"].state_dict())
    for k, v in sharded["net"].gather().items():
        assert torch.equal(v, want[k]), k
    umom = momentum(ustate, None)
    for k, v in momentum(sharded, None).items():
        assert torch.equal(v, umom[k]), k

    target2 = save_train_state(str(tmp_path / "sharded"), sharded, step=5)
    _, _, plain = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), use_aux=True, device="cpu")
    _, n = restore_train_state(target2, plain)
    assert n == 5
    for k, v in plain["net"].state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in momentum(plain, None).items():
        assert torch.equal(v, umom[k]), k
