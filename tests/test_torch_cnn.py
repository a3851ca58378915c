"""The port's CNNs (torchmpi_tpu_torch/models/{layers,lenet,resnet,alexnet}.py),
``weights.from_flax_cnn``, ``utils.data`` and ``gradsync.accumulate_gradients``
against the JAX package on the CPU.

The flax variables are the JAX model's init, perturbed by seeded noise (so
no BatchNorm scale is zero and no branch vanishes), loaded into the port's
model by ``from_flax_cnn``; the same seeded NHWC images go to the JAX model
and, permuted to NCHW, to the port's.  Tolerances are float32's: logits and
statistics within rtol 1e-4 (atol 1e-5 or 1e-4 for AlexNet's 9,216-wide
products), the two sides summing convolutions in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.models import AlexNet as JAlexNet
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.models import ResNet20 as JResNet20
from torchmpi_tpu.models import ResNet50 as JResNet50
from torchmpi_tpu.parallel.gradsync import accumulate_gradients as j_accum
from torchmpi_tpu.utils import data as jdata
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import weights as tweights
from torchmpi_tpu_torch.models import AlexNet, LeNet, ResNet20, ResNet50
from torchmpi_tpu_torch.models import layers
from torchmpi_tpu_torch.parallel.gradsync import accumulate_gradients
from torchmpi_tpu_torch.utils import data as tdata

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """Neither runtime is needed; stop any an earlier file left running."""
    jmpi.stop()
    tmpi.stop()
    yield
    tmpi.stop()
    jmpi.stop()


def _init(jmodel, shape, seed, noise=0.1, **kw):
    """The flax variables of ``jmodel`` at input ``shape`` (NHWC), every
    parameter perturbed by ``noise`` x N(0, 1), running variances drawn in
    [0.5, 1.5) and means N(0, 0.1)."""
    v = jax.jit(lambda k, x: jmodel.init(k, x, **kw))(
        jax.random.PRNGKey(seed), jnp.zeros(shape))
    rng = np.random.RandomState(seed)
    out = {"params": jax.tree.map(
        lambda a: np.asarray(a) + noise * rng.randn(*a.shape).astype(
            np.float32), v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (0.5 + rng.rand(*a.shape)).astype(np.float32)
            if p[-1].key == "var"
            else (0.1 * rng.randn(*a.shape)).astype(np.float32),
            v["batch_stats"])
    return out


def _images(n, size, ch, seed=3):
    return np.random.RandomState(seed).rand(n, size, size, ch).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port(cls, variables, **kw):
    model = cls(device="cpu", **kw)
    model.load_state_dict(tweights.from_flax_cnn(variables, model))
    return model


@pytest.mark.parametrize("size,k,s", [
    (224, 7, 2), (56, 3, 2), (224, 11, 4), (33, 3, 2), (32, 3, 2), (28, 5, 1),
    (7, 3, 2), (1, 3, 2), (112, 3, 2), (17, 1, 2)])
def test_same_pads_match_xla(size, k, s):
    """``layers.same_pads`` is XLA's "SAME" split (lo, hi), for the shapes
    the models hit: (2, 3) at ResNet-50's stem, (0, 1) at stride-2 3 x 3 on
    even sizes, (3, 4) at AlexNet's 11 x 11 / 4, (1, 1) at 33."""
    want = tuple(jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0])
    assert layers.same_pads(size, k, s) == want


def test_same_pads_asymmetric_cases():
    assert layers.same_pads(224, 7, 2) == (2, 3)
    assert layers.same_pads(112, 3, 2) == (0, 1)
    assert layers.same_pads(224, 11, 4) == (3, 4)
    assert layers.same_pads(33, 3, 2) == (1, 1)


def test_lenet_matches_flax():
    jm = JLeNet()
    v = _init(jm, (1, 28, 28, 1), seed=0)
    x = _images(4, 28, 1)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    got = _port(LeNet, v)(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)


def _compare_stats(model, new_stats_tree, rtol=1e-4, atol=1e-6):
    """The port's new running statistics against flax's updated
    ``batch_stats``."""
    names = layers.batch_stats_names(model)
    got = dict(zip(names, layers.new_batch_stats(model)))
    ref = _stats_by_name(new_stats_tree)
    assert set(ref) == set(got)
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _stats_by_name(tree):
    """The port's buffer names of a flax ``batch_stats`` tree."""
    out = {}
    for path, a in tweights._flax_leaves(tree):
        name = ".".join([tweights._cnn_module(p) for p in path[:-1]]
                        + [tweights._CNN_LEAVES[path[-1]]])
        out[name] = a
    return out


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet20_matches_flax(size, train):
    """ResNet-20 at 32 (stride-2 convs split (0, 1)) and 33 ((1, 1)), in
    training mode (batch statistics, and the new running statistics) and
    eval mode (running statistics)."""
    jm = JResNet20()
    v = _init(jm, (1, size, size, 3), seed=1, train=False)
    x = _images(4, size, 3)
    model = _port(ResNet20, v)
    got = model(_nchw(x), train=train)
    if train:
        want, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
        _compare_stats(model, jax.tree.map(np.asarray, upd["batch_stats"]))
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    # The running buffers are untouched by the forward.
    assert all(torch.equal(b, torch.from_numpy(np.asarray(ref)))
               for b, ref in zip(layers.batch_stats(model),
                                 [_stats_by_name(v["batch_stats"])[n] for n
                                  in layers.batch_stats_names(model)]))


def test_resnet50_matches_flax_small_input():
    """One small forward of ResNet-50 (64 x 64, 10 classes), training mode:
    the stem's 7 x 7 / 2 conv pads (2, 3), its max-pool and every stride-2
    3 x 3 conv (0, 1)."""
    assert layers.same_pads(64, 7, 2) == (2, 3)
    assert layers.same_pads(32, 3, 2) == (0, 1)
    jm = JResNet50(num_classes=10)
    v = _init(jm, (1, 64, 64, 3), seed=2, noise=0.02, train=False)
    x = _images(2, 64, 3)
    model = _port(ResNet50, v, num_classes=10)
    got = model(_nchw(x), train=True)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _compare_stats(model, jax.tree.map(np.asarray, upd["batch_stats"]),
                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("size", [1, 2])
def test_block_projects_where_flax_does(kind, size):
    """A stride-2 residual block with equal channels, training mode: on a
    1 x 1 map it keeps its shape, flax's init has no projection and
    applies none, and ``from_flax_cnn`` drops the port's; on a 2 x 2 map
    both project.  Outputs within the file's tolerance."""
    from functools import partial

    import flax.linen as fnn

    from torchmpi_tpu.models import resnet as jresnet
    from torchmpi_tpu_torch.models import resnet as tresnet

    filters, expansion = (8, 1) if kind == "basic" else (4, 4)
    ch = filters * expansion
    jcls = jresnet.BasicBlock if kind == "basic" else jresnet.BottleneckBlock
    jm = jcls(filters=filters, strides=(2, 2), act=fnn.relu,
              conv=partial(fnn.Conv, use_bias=False, padding="SAME"),
              norm=partial(fnn.BatchNorm, use_running_average=False,
                           momentum=0.9, epsilon=1e-5))
    v = _init(jm, (1, size, size, ch), seed=5)
    assert ("conv_proj" in v["params"]) == (size > 1)
    tcls = tresnet.BasicBlock if kind == "basic" else tresnet.BottleneckBlock
    block = tcls(ch, filters, (2, 2),
                 conv=partial(layers.Conv2d, use_bias=False, device="cpu"),
                 norm=partial(layers.BatchNorm, momentum=0.9, eps=1e-5,
                              device="cpu"))
    block.load_state_dict(tweights.from_flax_cnn(v, block))
    assert hasattr(block, "conv_proj") == (size > 1)
    x = _images(4, size, ch, seed=6)
    got = block(_nchw(x), train=True)
    want, _ = jm.apply(v, x, mutable=["batch_stats"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)


def test_alexnet_matches_flax_eval():
    """AlexNet at 224 x 224 with ``train=False`` (dropout masks cannot
    match JAX's, so parity runs without them): the 11 x 11 / 4 conv pads
    (3, 4)."""
    jm = JAlexNet(num_classes=10)
    v = _init(jm, (1, 224, 224, 3), seed=3, noise=0.0, train=False)
    x = _images(1, 224, 3)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, x))
    got = _port(AlexNet, v, num_classes=10)(_nchw(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_alexnet_dropout_draws_from_the_models_generator():
    """Training mode applies dropout from the model's own generator:
    seeded alike, two models give the same output; dropout=0 is the eval
    output."""
    kw = dict(num_classes=5, image_size=64, device="cpu")
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    a = AlexNet(**kw, dropout_seed=7)
    b = AlexNet(**kw, dropout_seed=7)
    assert torch.equal(a(x, train=True), b(x, train=True))
    assert not torch.equal(a(x, train=True), a(x, train=False))
    c = AlexNet(**kw, dropout=0.0)
    assert torch.equal(c(x, train=True), c(x, train=False))


def test_batchnorm_running_variance_is_flax_biased():
    """A training-mode BatchNorm's new running variance is flax's (the
    biased batch variance, decay 0.9); ``nn.BatchNorm2d``'s unbiased
    update gives another result on the same batch."""
    import flax.linen as fnn

    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 3, 4).astype(np.float32) * 2 + 1   # NHWC, 18 a channel
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_j, upd = bn.apply(v, x, mutable=["batch_stats"])
    m = layers.BatchNorm(4, device="cpu")
    y_t = m(_nchw(x), use_running_average=False)
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    mean, var = (t.numpy() for t in m.new_stats)
    np.testing.assert_allclose(mean, np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(var, np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    # The buffers are untouched until committed.
    assert torch.equal(m.running_var, torch.ones(4))
    layers.commit_batch_stats(m)
    assert torch.equal(m.running_var, m.new_stats[1])
    ref = torch.nn.BatchNorm2d(4, momentum=0.1)
    ref.train()
    ref(_nchw(x))
    assert not np.allclose(ref.running_var.numpy(), var, rtol=1e-3)


def test_bf16_compute_keeps_f32_params_and_logits():
    model = ResNet50(num_classes=10, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in layers.batch_stats(model))
    out = model(torch.zeros(2, 3, 32, 32), train=False)
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    model(torch.rand(2, 3, 32, 32), train=True)
    assert all(s.dtype == torch.float32
               for s in layers.new_batch_stats(model))


def test_init_follows_flax():
    """lecun-normal kernels (truncated at 2 std, variance 1 / fan_in),
    zero biases, BN scale one, each block's last BN scale zero."""
    model = ResNet20(device="cpu",
                     generator=torch.Generator().manual_seed(3))
    w = model.blocks[4].conv1.weight
    fan_in = w[0].numel()
    assert abs(float(w.detach().var()) * fan_in - 1.0) < 0.1
    bound = 2 / 0.87962566103423978 / fan_in ** 0.5
    assert float(w.detach().abs().max()) <= bound
    assert torch.equal(model.blocks[0].bn1.weight, torch.zeros(16))
    assert torch.equal(model.blocks[0].bn0.weight, torch.ones(16))
    assert torch.equal(model.dense0.bias, torch.zeros(10))
    assert sum(p.numel() for p in model.parameters()) == 272_474


def test_from_flax_cnn_refuses_a_mismatch():
    v = _init(JLeNet(), (1, 28, 28, 1), seed=0)
    with pytest.raises(ValueError, match="do not match"):
        tweights.from_flax_cnn(v, ResNet20(device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        tweights.from_flax_cnn(v, LeNet(num_classes=5, device="cpu"))


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default succeeds")
    for build in (LeNet, AlexNet, ResNet20):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("fn,kw", [
    ("synthetic_mnist", {}), ("synthetic_cifar", {}),
    ("synthetic_imagenet", {"image_size": 16, "num_classes": 7})])
def test_data_is_bitwise_the_jax_packages(fn, kw):
    a = getattr(jdata, fn)(40, seed=3, **kw)
    b = getattr(tdata, fn)(40, seed=3, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    ja = list(jdata.batches(*a, 8, steps=3, seed=1))
    tb = list(tdata.batches(*b, 8, steps=3, seed=1))
    assert all(np.array_equal(p, q) for u, v in zip(ja, tb)
               for p, q in zip(u, v))


def test_accumulate_gradients_matches_jax():
    """tests/test_gradsync.py:245 as the spec: 4 microbatches of an MLP's
    mean loss equal JAX's accumulation and the full-batch gradient; a
    ragged batch raises; n_accum=1 is the plain gradient."""
    rng = np.random.RandomState(0)
    w, b = rng.randn(8, 4).astype(np.float32), rng.randn(4).astype(
        np.float32)
    X = rng.randn(16, 8).astype(np.float32)
    Y = rng.randint(0, 4, size=16).astype(np.int32)

    def j_loss(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            x @ p["w"] + p["b"], y).mean()

    jl, jg = jax.jit(lambda p, x, y: j_accum(j_loss, p, x, y, n_accum=4))(
        {"w": w, "b": b}, X, Y)

    def t_loss(p, x, y):
        return torch.nn.functional.cross_entropy(x @ p[0] + p[1], y.long())

    params = [torch.from_numpy(w), torch.from_numpy(b)]
    tl, tg = accumulate_gradients(t_loss, params, torch.from_numpy(X),
                                  torch.from_numpy(Y), n_accum=4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    for got, want in zip(tg, (jg["w"], jg["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    fl, fg = accumulate_gradients(t_loss, params, torch.from_numpy(X),
                                  torch.from_numpy(Y), n_accum=1)
    for a, c in zip(tg, fg):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(fl), float(tl), rtol=1e-6)
    assert params[0].grad is None and not params[0].requires_grad
    with pytest.raises(ValueError, match="divisible"):
        accumulate_gradients(t_loss, params, torch.from_numpy(X[:15]),
                             torch.from_numpy(Y[:15]), n_accum=4)


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (``torchmpi_tpu``, as opposed to ``torchmpi_tpu_torch``)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|torchmpi_tpu)"
                     r"(\s|\.|,|$)")
    files = sorted((root / "torchmpi_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 30
    bad = [f"{f.relative_to(root)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad
