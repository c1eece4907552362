"""The port's ReID trainer (train/reid_trainer.py) and the backward of its
batch norm (K6b's plain version) against the JAX package.

MINI ``FastReIDSBS`` in float32 on both sides, the JAX variables carried
into the port by runtime/from_flax.py, the same numpy-seeded images.
Tolerances:
- the triplet loss on seeded features: relative 1e-6 (one float32 matrix
  product and a handful of reductions);
- ``bn_act_backward_plain`` against ``torch.autograd`` of ``bn_act_plain``:
  grad_x bit for bit (the same float32 operations and roundings), the [C]
  gradients within 1e-6 of the sum of their terms' magnitudes (autograd
  sums in float32, the plain backward in float64);
- every leaf's first-step gradient against ``jax.grad``: relative L2 1e-4.
  Both sides compute in float32 with sums in different orders, so a ReLU
  whose input lies within float32 noise of 0 can switch between the two
  (one such element moves its layer's gradient by about 5e-4); the test
  asserts that every nonzero ReLU input of its batch is at least 1e-6 away
  from 0, so the comparison is one of the same function;
- one AdamW update against ``optax.adamw`` on the same gradients: 1e-6
  (the same update in another order of float32 operations);
- three steps against JAX's ``make_trainer(make_mesh(2))``: losses within
  1e-3 relative (Adam amplifies the gradients' last-bit differences:
  where a gradient is near zero its sign decides a whole ``lr`` step);
- two replicas on (cpu, cpu) against one device: gradients relative L2
  1e-5 (the replicas' sums are added in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from botsort_tpu.models import FastReIDSBS as JFastReIDSBS
from botsort_tpu.parallel.streams import make_mesh as jmake_mesh
from botsort_tpu.runtime.assets import MINI as JMINI
from botsort_tpu.train import reid_trainer as jtrainer
from botsort_tpu_torch.models import bn_act
from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.models.fastreid import FastReIDSBS
from botsort_tpu_torch.runtime import from_flax
from botsort_tpu_torch.train import reid_trainer as trainer

CPU = torch.device("cpu")
N_IMAGES = 16
# The seed of the images and the JAX init: one whose nonzero ReLU inputs
# all lie at least 1e-6 from 0 (seeds 0-7 give 4e-8 to 2.6e-6).
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    """(JAX model, its variables, images, labels): MINI float32, seeded."""
    model = JFastReIDSBS(dtype=jnp.float32, **JMINI["body"])
    rng = np.random.default_rng(SEED)
    images = rng.normal(size=(N_IMAGES, 64, 32, 3)).astype(np.float32)
    labels = (np.arange(N_IMAGES) % 4).astype(np.int32)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(SEED), jnp.asarray(images[:1])))
    return model, variables, images, labels


def _port_model(variables):
    model = FastReIDSBS(**JMINI["body"])
    return from_flax.load_flax_variables(model, variables)


def _port_name(model, path):
    """The port's leaf name of a Flax leaf path, and its layout
    conversion."""
    _, *mod_path, leaf = [str(getattr(p, "key", p)) for p in path]
    sub = model
    for name in mod_path:
        sub = sub._modules[name]
    attr, convert = from_flax._LEAVES[type(sub)][leaf]
    return ".".join(mod_path + [attr]), convert


def _flax_leaves(model, tree):
    """{port name: the Flax leaf in the port's layout}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, convert = _port_name(model, path)
        out[name] = convert(np.asarray(leaf, np.float32))
    return out


def _relu_margin(model, images):
    """The smallest nonzero |input| of any ReLU that follows a batch norm in
    the model's forward over ``images`` (an exact 0 comes from an all-zero
    receptive field, which both sides compute exactly)."""
    margins = []

    def hook(module, args):
        if len(args) > 1 and args[1] == "relu":
            y = bn_act.bn_act_plain(args[0], module.running_mean,
                                    module.mul(), module.bias)
            nonzero = y.abs()[y != 0]
            if nonzero.numel():
                margins.append(float(nonzero.min()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(torch.from_numpy(images))
    finally:
        for h in handles:
            h.remove()
    return min(margins)


def _unit_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_triplet_loss_matches_jax():
    rng = np.random.default_rng(7)
    for n, d, ids in ((16, 32, 4), (12, 8, 3), (9, 5, 9)):
        feats = _unit_rows(rng.normal(size=(n, d)).astype(np.float32))
        labels = (np.arange(n) % ids).astype(np.int32)
        want = float(jtrainer.batch_hard_triplet_loss(
            jnp.asarray(feats), jnp.asarray(labels)))
        got = float(trainer.batch_hard_triplet_loss(
            torch.from_numpy(feats), torch.from_numpy(labels)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_triplet_loss_orders_correctly():
    """tests/test_train.py's ordering case on the port's loss."""
    a = _unit_rows(np.array([[1, 0, 0], [0.99, 0.1, 0]], np.float32))
    b = _unit_rows(np.array([[0, 1, 0], [0.1, 0.99, 0]], np.float32))
    labels = torch.tensor([0, 0, 1, 1])
    good = float(trainer.batch_hard_triplet_loss(
        torch.from_numpy(np.concatenate([a, b])), labels, margin=0.3))
    assert good < 0.05
    bad = float(trainer.batch_hard_triplet_loss(torch.from_numpy(_unit_rows(
        np.array([[1, 0, 0], [0, 1, 0], [1, 0.05, 0], [0, 1, 0.05]],
                 np.float32))), labels, margin=0.3))
    assert bad > good


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", bn_act.ACTS)
def test_bn_act_backward_plain_equals_autograd(act, dtype):
    rng = np.random.default_rng(len(act))
    for shape in ((3, 7, 5, 4), (4, 6), (2, 5, 9)):
        c = shape[1]
        x = torch.from_numpy(2 * rng.normal(size=shape).astype(
            np.float32)).to(dtype)
        grad = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
        mean, bias = (torch.from_numpy(0.5 * rng.normal(size=c).astype(
            np.float32)) for _ in range(2))
        mul = torch.from_numpy(rng.uniform(0.3, 1.8, c).astype(np.float32))
        leaves = [t.clone().requires_grad_() for t in (x, mean, mul, bias)]
        bn_act.bn_act_plain(*leaves, act).backward(grad)
        grad_x, sum_gy, sum_gyx = bn_act.bn_act_backward_plain(
            grad, x, mean, mul, bias, act)
        assert grad_x.dtype == dtype and torch.equal(grad_x, leaves[0].grad)
        # Each [C] gradient against autograd's, within 1e-6 of the sum of
        # its terms' magnitudes.
        dims = [0] + list(range(2, x.dim()))
        shp = (1, -1) + (1,) * (x.dim() - 2)
        g_abs = grad.float().abs()
        scales = (mul.abs() * g_abs.sum(dims),
                  (g_abs * (x.float() - mean.view(shp)).abs()).sum(dims),
                  g_abs.sum(dims))
        for got, want, scale in zip(
                bn_act.bn_act_grads(mul, sum_gy, sum_gyx),
                (leaves[1].grad, leaves[2].grad, leaves[3].grad), scales):
            assert torch.all((got - want).abs() <= 1e-6 * scale + 1e-12)
        # The eager autograd route and the custom op's registered backward
        # give the plain backward's gradients exactly.
        for route in (bn_act.bn_act, bn_act.bn_act_op):
            mine = [t.clone().requires_grad_() for t in (x, mean, mul, bias)]
            route(*mine, act).backward(grad)
            for got, want in zip(mine, (grad_x, *bn_act.bn_act_grads(
                    mul, sum_gy, sum_gyx))):
                assert torch.equal(got.grad, want)


def test_batchnorm_mul_keeps_its_graph_and_refreshes_after_a_step():
    """A gradient reaches the scale and the variance through ``mul``; an
    in-place optimiser update afterwards refreshes the inference cache."""
    bn = BatchNorm(5, 1e-5)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(3, 5, 4, 4)
    bn.running_var.requires_grad_()
    bn(x, "relu").sum().backward()
    assert bn.weight.grad is not None and bn.running_var.grad is not None
    assert bn.weight.grad.abs().sum() > 0
    bn.running_var.requires_grad_(False)
    with torch.no_grad():
        first = bn.mul().clone()
        bn.weight.mul_(2.0)                     # an in-place update
        assert torch.allclose(bn.mul(), 2 * first)
        assert not bn.mul().requires_grad


def test_first_step_gradients_match_jax(setup):
    jmodel, variables, images, labels = setup
    model = _port_model(variables)
    assert _relu_margin(model, images) > 1e-6

    def loss_fn(v):
        return jtrainer.batch_hard_triplet_loss(
            jmodel.apply(v, jnp.asarray(images)), jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    init_fn, train_step = trainer.make_trainer(model, (CPU,))
    state = init_fn()
    loss, grads = train_step.value_and_grad(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = _flax_leaves(model, jax.device_get(jgrads))
    assert len(want) == len(grads) == len(trainer.trained_names(model))
    assert sum(1 for n in grads if n.endswith(("running_mean",
                                               "running_var"))) == \
        len(jax.tree_util.tree_leaves(variables["batch_stats"]))
    for name, w in want.items():
        g = grads[name].numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < 1e-4, (name, rel)


def test_adamw_update_matches_optax(setup):
    _, variables, images, labels = setup
    model = _port_model(variables)
    init_fn, train_step = trainer.make_trainer(model, (CPU,),
                                               learning_rate=3.5e-4)
    state = init_fn()
    _, grads = train_step.value_and_grad(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    params = {n: p.numpy().copy() for n, p in state.params.items()}
    tx = optax.adamw(3.5e-4)
    jparams = {n: jnp.asarray(p) for n, p in params.items()}
    jgrads = {n: jnp.asarray(g.numpy()) for n, g in grads.items()}
    want = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(jgrads, jparams)
    for name, p in state.params.items():
        p.grad = grads[name]
    state.opt_state.step()
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)


def test_two_replicas_equal_one_device(setup):
    _, variables, images, labels = setup
    out = []
    for mesh in ((CPU,), (CPU, CPU)):
        init_fn, train_step = trainer.make_trainer(
            _port_model(variables), mesh)
        state = init_fn()
        out.append(train_step.value_and_grad(
            state, torch.from_numpy(images), torch.from_numpy(labels)))
    assert float(out[1][0]) == pytest.approx(float(out[0][0]), rel=1e-6)
    for name, g in out[0][1].items():
        rel = float((out[1][1][name] - g).norm() / max(float(g.norm()),
                                                      1e-30))
        assert rel < 1e-5, (name, rel)


def test_three_steps_match_jax_on_two_devices(setup):
    jmodel, variables, images, labels = setup
    jmesh = jmake_mesh(2)
    jinit, jstep = jtrainer.make_trainer(jmodel, jmesh)
    jstate = jinit(jax.random.PRNGKey(SEED), jnp.asarray(images[:1]))
    sharding = NamedSharding(jmesh, P("stream"))
    jimages = jax.device_put(jnp.asarray(images), sharding)
    jlabels = jax.device_put(jnp.asarray(labels), sharding)
    init_fn, train_step = trainer.make_trainer(_port_model(variables),
                                               (CPU, CPU))
    state = init_fn()
    for _ in range(3):
        jstate, jloss = jstep(jstate, jimages, jlabels)
        state, loss = train_step(state, torch.from_numpy(images),
                                 torch.from_numpy(labels))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    assert state.step == int(jstate.step) == 3
