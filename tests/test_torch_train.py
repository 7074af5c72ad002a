"""The port's UFLDv2 trainer (``adas_tpu_torch/parallel/train.py``), aux
segmentation head and test-time augmentation (``models/ufld.py``)
against the JAX package's (``adas_tpu/parallel/train.py``,
``adas_tpu/models/ufld.py``) on the same initial weights and batch.

Small sizes, as ``tests/test_parallel.py`` trains: UFLDv2 with a
ResNet-18 trunk at 64x128, 16 cells, 8 rows and columns, a 64-wide MLP,
batch 4, the aux head on.  One JAX train state, jitted once, takes 3 SGD
steps (lr 0.02, momentum 0.9) on a mesh of one CPU device; the port takes
the same 3 steps from the same flax tree, carried over by the weight
bridge.  Tolerances: the first loss within rel 2e-5 (JAX's own bound
between meshes, ``tests/test_parallel.py:83``), the later ones within
rel 1e-3.  The weights after 3 steps are compared in f64 (JAX's net built
with ``dtype=float64`` under ``jax.enable_x64``, its loss and optax's sgd,
against the port's net cast to f64): in f32 both trainers' BatchNorm
backward (``E[x^2] - E[x]^2``, flax's fast variance) cancels on a few
leaves, which then move 5-20% off each framework's own f64 step, so only
f64 shows the semantics: params, batch statistics (flax's biased variance
into the running statistics, momentum 0.9) and optax's momentum trace
within 1e-6 of each leaf's largest move (``MOVE_TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.parallel import make_mesh
from adas_tpu.parallel import train as jax_train
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu_torch.models import resnet
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.parallel import make_ufld_train_state, make_ufld_train_step, ufld_loss
from adas_tpu_torch.weights import flax_variables, load_flax_variables, state_dict_from_flax
from test_torch_models import _close, _unflatten, random_flax_weights

SPEC_ARGS = dict(
    input_height=64, input_width=128, crop_ratio=0.8, num_cell_row=16, num_row=8,
    num_cell_col=16, num_col=8, fc_norm=True, mlp_mid=64, img_w=128, img_h=64,
)
LR = 0.02
STEPS = 3
# f64 moves of the two trainers agree to this fraction of each leaf's
# largest move from the initial tree
MOVE_TOL = 1e-6


def make_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.normal(size=(b, 64, 128, 3)).astype(np.float32),
        "row_targets": rng.integers(0, 16, (b, 8, 4)),
        "col_targets": rng.integers(0, 16, (b, 8, 4)),
        "row_exist": rng.integers(0, 2, (b, 8, 4)),
        "col_exist": rng.integers(0, 2, (b, 8, 4)),
        # the seg head's stride-8 grid
        "seg_targets": rng.integers(0, 5, (b, 8, 16)),
    }


def torch_batch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out["images"] = out["images"].permute(0, 3, 1, 2).contiguous()
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer: the initial flat tree, the loss of each step and the
    final params, batch statistics and momentum (one jit)."""
    mesh = make_mesh(1)
    net, tx, state = jax_train.make_ufld_train_state(
        JaxUFLDv2Spec(**SPEC_ARGS), mesh, jax.random.PRNGKey(0), learning_rate=LR, use_aux=True)
    init = flatten_variables(jax.device_get(
        {"params": state["params"], "batch_stats": state["batch_stats"]}))
    step = jax_train.make_ufld_train_step(net, tx, mesh, state)
    batch = make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jb)
        losses.append(float(loss))
    return {"init": init, "batch": batch, "losses": losses, **jax_f64_steps(init, batch)}


def jax_f64_steps(init, batch):
    """JAX's train step (``train.py:123-143``) in f64: the f64 net, JAX's
    ``ufld_loss`` and optax's sgd from the f32 initial tree, 3 steps."""
    import optax

    with jax.enable_x64(True):
        net = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS), dtype=jnp.float64, use_aux=True)
        tree = unflatten_variables({k: np.asarray(v, np.float64) for k, v in init.items()})
        params, stats = jax.tree_util.tree_map(jnp.asarray, (tree["params"], tree["batch_stats"]))
        tx = optax.sgd(LR, momentum=0.9)
        opt = tx.init(params)
        jb = {k: jnp.asarray(v, jnp.float64 if k == "images" else None) for k, v in batch.items()}

        @jax.jit
        def step(params, stats, opt):
            def loss_fn(p):
                out, mut = net.apply({"params": p, "batch_stats": stats}, jb["images"],
                                     train=True, mutable=["batch_stats"])
                return jax_train.ufld_loss(out, jb), mut["batch_stats"]

            (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt = tx.update(grads, opt, params)
            return optax.apply_updates(params, updates), stats, opt

        for _ in range(STEPS):
            params, stats, opt = step(params, stats, opt)
        params, stats, opt = jax.device_get((params, stats, opt))
    return {"final": flatten_variables({"params": params, "batch_stats": stats}),
            "trace": flatten_variables({"params": opt[0].trace})}


@pytest.fixture(scope="module")
def port_run(jax_run):
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), learning_rate=LR,
                                            use_aux=True, device="cpu")
    load_flax_variables(net, jax_run["init"])
    step = make_ufld_train_step(net, opt)
    batch = torch_batch(jax_run["batch"])
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    # the same steps in f64 from the same tree
    net64, opt64, state64 = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), learning_rate=LR,
                                                  use_aux=True, device="cpu")
    load_flax_variables(net64, jax_run["init"])
    net64.double()
    step64 = make_ufld_train_step(net64, opt64)
    batch64 = dict(batch, images=batch["images"].double())
    for _ in range(STEPS):
        step64(state64, batch64)
    return {"losses": losses, "net64": net64, "opt64": opt64}


def test_first_step_loss_matches_jax(jax_run, port_run):
    assert port_run["losses"][0] == pytest.approx(jax_run["losses"][0], rel=2e-5)


def test_later_losses_match_jax(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=1e-3)
    assert port_run["losses"][-1] < port_run["losses"][0]


def displacement_error(got, want, init):
    """max |got - want| over the leaf's largest move from ``init`` (the
    JAX side's)."""
    return float(np.abs(got - want).max() / max(np.abs(want - init).max(), 1e-30))


@pytest.mark.parametrize("coll", ["params", "batch_stats"])
def test_weights_after_steps_match_jax(jax_run, port_run, coll):
    """Flax's BatchNorm and optax's momentum SGD move every leaf alike
    (f64, within ``MOVE_TOL`` of each leaf's largest move)."""
    got = flax_variables(port_run["net64"])
    keys = [k for k in jax_run["final"] if k.startswith(coll + "::")]
    assert keys and set(keys) == {k for k in got if k.startswith(coll + "::")}
    for k in keys:
        err = displacement_error(got[k], np.asarray(jax_run["final"][k]), jax_run["init"][k])
        assert err < MOVE_TOL, (k, err)


def test_running_var_is_biased():
    """One training forward puts flax's statistics into the buffers: 0.9 *
    the old + 0.1 * the batch's biased variance (torch's own BatchNorm
    would take the unbiased one)."""
    from adas_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(3).train()
    x = torch.from_numpy(np.random.default_rng(4).normal(2.0, 3.0, (2, 3, 4, 5)).astype(np.float32))
    bn(x)
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var.numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.double().mean(dim=(0, 2, 3)).numpy(), rtol=1e-5)


def test_momentum_matches_optax_trace(jax_run, port_run):
    """torch's SGD buffer (momentum * buf + g, dampening 0) against optax's
    trace (g + momentum * trace) after 3 steps (f64, within ``MOVE_TOL``
    of each leaf's largest value)."""
    names = {id(p): n for n, p in port_run["net64"].named_parameters()}
    got = {names[id(p)]: s["momentum_buffer"].numpy()
           for p, s in port_run["opt64"].state.items()}
    want = state_dict_from_flax(jax_run["trace"])
    assert set(got) == set(want)
    for k, v in want.items():
        err = displacement_error(got[k], v.numpy(), 0.0)
        assert err < MOVE_TOL, (k, err)


def test_sgd_equals_optax_update():
    """Two steps of the update on fixed gradients, to the bit: torch's
    SGD(momentum, dampening=0) and optax's sgd with momentum."""
    import optax

    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(7,)).astype(np.float32)
    grads = [rng.normal(size=(7,)).astype(np.float32) for _ in range(3)]
    tx = optax.sgd(0.05, momentum=0.9)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=0.05, momentum=0.9, dampening=0.0)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_ufld_loss_matches_jax():
    rng = np.random.default_rng(6)
    outs = {
        "loc_row": rng.normal(size=(2, 16, 8, 4)), "loc_col": rng.normal(size=(2, 16, 8, 4)),
        "exist_row": rng.normal(size=(2, 2, 8, 4)), "exist_col": rng.normal(size=(2, 2, 8, 4)),
        "seg_out": rng.normal(size=(2, 5, 8, 16)),
    }
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    batch = {k: v[:2] for k, v in make_batch(7).items() if k != "images"}
    j_outs = {k: jnp.asarray(v) for k, v in outs.items()}
    j_outs["seg_out"] = jnp.asarray(outs["seg_out"].transpose(0, 2, 3, 1))  # JAX's NHWC
    t_outs = {k: torch.from_numpy(v) for k, v in outs.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for keep_seg in (True, False):
        jb = {k: jnp.asarray(v) for k, v in batch.items() if keep_seg or k != "seg_targets"}
        tb = {k: v for k, v in t_batch.items() if keep_seg or k != "seg_targets"}
        for w in (1.0, 0.3):
            want = float(jax_train.ufld_loss(j_outs, jb, aux_weight=w))
            got = float(ufld_loss(t_outs, tb, aux_weight=w))
            assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("tta", [False, True])
def test_aux_head_and_tta_match_jax(tta):
    """The eval forward with the aux head (``seg_out``, NCHW here, NHWC in
    JAX) and the 5-way shift of ``tta`` (``ufld.py:182-190``) on random
    weights with random BN statistics: JAX's tolerance for the trunk
    (``tests/test_torch_models.py``)."""
    jnet = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS), use_aux=True)
    x = np.random.default_rng(8).standard_normal((2, 64, 128, 3)).astype(np.float32)
    flat = random_flax_weights(jnet, (1, 64, 128, 3), seed=9)
    assert any(k.startswith("params::seg_head::comb4::") for k in flat)
    want = jax.jit(lambda v, x: jnet.apply(v, x, tta=tta))(_unflatten(flat), jnp.asarray(x))
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS), use_aux=True).eval()
    load_flax_variables(net, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), tta=tta)
    assert set(got) == set(want)
    assert got["loc_row"].shape[0] == (10 if tta else 2) and got["seg_out"].shape == (2, 5, 8, 16)
    for k in want:
        w = np.asarray(want[k])
        _close(got[k].numpy(), w.transpose(0, 3, 1, 2) if k == "seg_out" else w)
    # the seg head round-trips through the bridge both ways
    back = flax_variables(net)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_train_mode_stem_is_chosen_by_mode(monkeypatch):
    """The stem kernel's seam (``consume_stem``) serves eval mode only:
    training runs the plain conv -> BN -> ReLU -> pool whatever the
    device, by ``module.training`` alone, and the BN fold cached before
    training is made again after it."""
    calls = []
    real = resnet.consume_stem

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(resnet, "consume_stem", spy)
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), device="cpu")
    batch = torch_batch(make_batch(10, b=2))
    net.eval()
    with torch.no_grad():
        net(batch["images"])
    assert len(calls) == 1
    step = make_ufld_train_step(net, opt)
    step(state, batch)
    assert len(calls) == 1 and net.training
    net.eval()
    with torch.no_grad():
        got = net(batch["images"])
    fresh = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS)).eval()
    fresh.load_state_dict(net.state_dict())
    with torch.no_grad():
        want = fresh(batch["images"])
    assert len(calls) == 3
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_aux_loss_is_part_of_the_objective_and_falls():
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), learning_rate=LR,
                                            use_aux=True, device="cpu",
                                            generator=torch.Generator().manual_seed(3))
    assert any(n.startswith("seg_head.") for n, _ in net.named_parameters())
    batch = torch_batch(make_batch(3))
    step = make_ufld_train_step(net, opt)
    losses = [float(step(state, batch)[1]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    net.eval()
    with torch.no_grad():
        outs = net(batch["images"][:1])
    b1 = {k: v[:1] for k, v in batch.items()}
    without = {k: v for k, v in b1.items() if k != "seg_targets"}
    assert float(ufld_loss(outs, b1)) > float(ufld_loss(outs, without))


def test_single_gpu_rules():
    with pytest.raises(ValueError, match="mesh"):
        make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="aux"):
        UFLDv2Net(UFLDv2Spec(**SPEC_ARGS), int8=True, use_aux=True)
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), device="cpu")
    other = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), device="cpu")[2]
    with pytest.raises(ValueError, match="state"):
        make_ufld_train_step(net, opt)(other, torch_batch(make_batch(0, b=1)))
