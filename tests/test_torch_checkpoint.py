"""The port's training checkpoints (``adas_tpu_torch/parallel/checkpoint.py``,
the counterpart of ``adas_tpu/parallel/checkpoint.py``'s orbax store):
JAX's ``step_<8 digits>`` layout, an exact restore (params, BatchNorm
statistics, momentum and step, to the bit) and a resumed run equal to the
uninterrupted one, to the bit.  UFLDv2 at 64x128 with the aux head, batch
2, on the CPU (torch's CPU kernels are deterministic)."""
import os

import numpy as np
import pytest
import torch

from adas_tpu_torch.models.ufld import UFLDv2Spec
from adas_tpu_torch.parallel import (
    latest_checkpoint,
    make_ufld_train_state,
    make_ufld_train_step,
    restore_train_state,
    save_train_state,
)
from test_torch_train import SPEC_ARGS, make_batch, torch_batch

BATCH = torch_batch(make_batch(20, b=2))


def fresh(seed, **kw):
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), learning_rate=0.02,
                                            use_aux=True, device="cpu",
                                            generator=torch.Generator().manual_seed(seed), **kw)
    return make_ufld_train_step(net, opt), state


def snapshot(state):
    net, opt = state["net"], state["optimizer"]
    out = {f"p:{k}": v.detach().clone() for k, v in net.named_parameters()}
    out.update({f"b:{k}": v.clone() for k, v in net.named_buffers()})
    names = {id(p): k for k, p in net.named_parameters()}
    out.update({f"m:{names[id(p)]}": s["momentum_buffer"].clone() for p, s in opt.state.items()})
    return out


def assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_save_restore_is_exact(tmp_path):
    step, state = fresh(1)
    for _ in range(2):
        step(state, BATCH)
    root = str(tmp_path / "ckpt")
    target = save_train_state(root, state, step=2)
    assert target == latest_checkpoint(root) and target.endswith("step_00000002")
    assert os.path.isfile(os.path.join(target, "state.pt"))
    _, other = fresh(2)
    restored, n = restore_train_state(target, other)
    assert n == 2 and restored is other
    assert any(k.startswith("m:") for k in snapshot(state))
    assert_same(snapshot(restored), snapshot(state))


def test_resume_equals_uninterrupted_run(tmp_path):
    step, straight = fresh(3)
    losses = [float(step(straight, BATCH)[1]) for _ in range(4)]

    step_a, first = fresh(3)
    resumed_losses = [float(step_a(first, BATCH)[1]) for _ in range(2)]
    target = save_train_state(str(tmp_path), first, step=2)
    step_b, second = fresh(4)
    second, n = restore_train_state(target, second)
    resumed_losses += [float(step_b(second, BATCH)[1]) for _ in range(4 - n)]
    assert resumed_losses == losses
    assert_same(snapshot(second), snapshot(straight))
    # and it serves: eval mode folds the trained stem again
    second["net"].eval()
    straight["net"].eval()
    with torch.no_grad():
        a, b = second["net"](BATCH["images"]), straight["net"](BATCH["images"])
    for k in a:
        assert torch.equal(a[k], b[k])


def test_latest_checkpoint_picks_the_newest(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    _, state = fresh(5)
    for n in (7, 12, 3):
        save_train_state(str(tmp_path), state, step=n)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000012")


@pytest.mark.parametrize("use_aux", [False, True])
def test_restore_into_another_net_raises(tmp_path, use_aux):
    """A checkpoint of the aux net does not restore into a net without the
    head, nor the other way round."""
    net, opt, state = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), use_aux=use_aux,
                                            device="cpu")
    target = save_train_state(str(tmp_path), state, step=1)
    _, _, other = make_ufld_train_state(UFLDv2Spec(**SPEC_ARGS), use_aux=not use_aux,
                                        device="cpu")
    with pytest.raises(KeyError, match="do not match"):
        restore_train_state(target, other)
    np.testing.assert_equal(latest_checkpoint(str(tmp_path)), target)
