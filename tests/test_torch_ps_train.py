"""One-worker EASGD and Downpour built from each package's pieces, on the
CPU: the JAX package's ``ParameterServer``, flax model, optax and jitted
gradients beside the port's ``ParameterServer``, model (loaded with
``weights.from_flax_cnn`` from the same flax weights), ``optim.adam`` and
autograd, on the same seeded batches; the servers' centers are compared
leaf by leaf in the port's layout.

- EASGD (``mnist_easgd``'s loop: local SGD, an ``elastic`` exchange every
  ``tau`` steps with the delta subtracted locally), LeNet, 8 steps: the
  two sides differ only by the order of the convolutions' sums, and the
  measured gap is at most 2.0e-6 of a leaf's largest entry; held at 1e-5.
- Downpour (``alexnet_downpour``'s loop: each step Adam, an ``axpy`` push,
  a prefetch at step s adopted at s + 1 through ``wait()``), AlexNet at
  64 x 64, 3 steps.  Adam's first step moves every entry by about lr
  whatever the gradient's size, so an entry whose gradient is a few
  roundings from zero (|g| ~ 1e-8) and comes out with opposite signs on
  the two sides moves 2 lr apart; the moved weight then shifts
  activations across ReLU and max-pool near-ties, whose entries' changed
  gradients Adam again turns into steps of about lr.  Measured: every
  other entry within 1e-3 lr + 1e-5 |center|; at most 1.5e-4 of a leaf's
  entries outside that, none further apart than 0.72 lr.  Held: at most
  1e-3 of a leaf's entries (and at least one allowed) outside that
  tolerance, and every entry within 2 lr a step, the most two Adam
  trajectories of these steps can drift apart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torchmpi_tpu as jmpi
from torchmpi_tpu import parameterserver as jps
from torchmpi_tpu.models import AlexNet as JAlexNet
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.utils import data as jdata
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import optim, weights
from torchmpi_tpu_torch import parameterserver as tps
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import AlexNet, LeNet

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    jmpi.stop()
    tmpi.stop()
    old = os.environ.get("TORCHMPI_TPU_PS_TIMEOUT")
    os.environ["TORCHMPI_TPU_PS_TIMEOUT"] = "5"
    yield
    if old is None:
        os.environ.pop("TORCHMPI_TPU_PS_TIMEOUT", None)
    else:
        os.environ["TORCHMPI_TPU_PS_TIMEOUT"] = old
    tmpi.stop()
    jmpi.stop()


def _flax(jmodel, shape, **kw):
    v = jax.jit(lambda k, x: jmodel.init(k, x, **kw))(
        jax.random.PRNGKey(0), jnp.zeros(shape))
    return jax.tree.map(np.asarray, v["params"])


def _port(model, params):
    model.load_state_dict(weights.from_flax_cnn({"params": params}, model))
    return model


def _centers(jcenter, tcenter, model):
    """Both centers as {name: tensor} in the port's layout."""
    ref = weights.from_flax_cnn({"params": jcenter}, model)
    return {n: (tcenter[n], ref[n]) for n in ref}


def test_easgd_one_worker_matches_jax():
    steps, bs, lr, tau, alpha = 8, 16, 0.02, 2, 0.3
    jm = JLeNet()
    p0 = _flax(jm, (1, 28, 28, 1))
    X, Y = jdata.synthetic_mnist(256, seed=0)
    batches = list(jdata.batches(X, Y, bs, steps=steps, seed=1))

    def loss_fn(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply({"params": p}, x), y).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    jserver = jps.init(p0, num_shards=2)
    params = jax.tree.map(jnp.asarray, p0)
    for s, (xb, yb) in enumerate(batches):
        _, g = grad_fn(params, jnp.asarray(xb), jnp.asarray(yb))
        params = jax.tree.map(lambda p, g: p - lr * g, params, g)
        if s % tau == tau - 1:
            d = jserver.send(params, rule="elastic", alpha=alpha).wait()
            params = jax.tree.map(lambda p, d: p - jnp.asarray(d), params, d)
    jcenter = jserver.receive().wait()
    jserver.shutdown()

    model = _port(LeNet(device="cpu"), p0)
    tserver = tps.init(common.params_tree(model), num_shards=2)
    names, tparams = zip(*model.named_parameters())
    for s, (xb, yb) in enumerate(batches):
        x, y = common.to_device(xb, yb, CPU)
        grads = torch.autograd.grad(F.cross_entropy(model(x), y), tparams)
        with torch.no_grad():
            for p, g in zip(tparams, grads):
                p.sub_(lr * g)
        if s % tau == tau - 1:
            d = tserver.send(common.params_tree(model), rule="elastic",
                             alpha=alpha).wait()
            with torch.no_grad():
                for n, p in zip(names, tparams):
                    p.sub_(d[n])
    tcenter = tserver.receive().wait()
    tserver.shutdown()

    for n, (got, want) in _centers(jcenter, tcenter, model).items():
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale, n


def test_downpour_one_worker_matches_jax():
    steps, bs, lr, fetch_every, size, classes = 3, 4, 3e-4, 2, 64, 10
    jm = JAlexNet(num_classes=classes, dropout=0.0)
    p0 = _flax(jm, (1, size, size, 3), train=False)
    X, Y = jdata.synthetic_image_classification(
        64, image_shape=(size, size, 3), num_classes=classes, seed=0)
    batches = list(jdata.batches(X, Y, bs, steps=steps, seed=1))
    tx = optax.adam(lr)

    def loss_fn(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply({"params": p}, x, train=False), y).mean()

    @jax.jit
    def local_step(p, st, x, y):
        g = jax.grad(loss_fn)(p, x, y)
        return tx.update(g, st, p)

    jserver = jps.init(p0, num_shards=4)
    params = jax.tree.map(jnp.asarray, p0)
    st, fetch = tx.init(params), None
    for s, (xb, yb) in enumerate(batches):
        u, st = local_step(params, st, jnp.asarray(xb), jnp.asarray(yb))
        jserver.send(jax.tree.map(np.asarray, u), rule="axpy", alpha=1.0)
        params = optax.apply_updates(params, u)
        if fetch is not None:
            params = jax.tree.map(jnp.asarray, fetch.wait())
            fetch = None
        elif s % fetch_every == 0:
            fetch = jserver.receive()
    jcenter = jserver.receive().wait()
    jserver.shutdown()

    model = _port(AlexNet(classes, dropout=0.0, image_size=size,
                          device="cpu"), p0)
    tserver = tps.init(common.params_tree(model), num_shards=4)
    names, tparams = zip(*model.named_parameters())
    ttx = optim.adam(lr)
    states, fetch, adopted = [ttx.init(p.detach()) for p in tparams], None, 0
    for s, (xb, yb) in enumerate(batches):
        x, y = common.to_device(xb, yb, CPU)
        grads = torch.autograd.grad(
            F.cross_entropy(model(x, train=False), y), tparams)
        ups = {}
        for i, (n, g) in enumerate(zip(names, grads)):
            ups[n], states[i] = ttx.update(g, states[i])
        tserver.send(ups, rule="axpy", alpha=1.0)
        with torch.no_grad():
            for n, p in zip(names, tparams):
                p.add_(ups[n])
        if fetch is not None:
            common.load_params(model, fetch.wait())
            fetch, adopted = None, adopted + 1
        elif s % fetch_every == 0:
            fetch = tserver.receive()
    tcenter = tserver.receive().wait()
    tserver.shutdown()
    assert adopted == 1

    for n, (got, want) in _centers(jcenter, tcenter, model).items():
        d = (got - want).abs()
        assert float(d.max()) <= 2 * lr * steps, n
        off = int((d > 1e-3 * lr + 1e-5 * want.abs()).sum())
        assert off <= max(1, d.numel() // 1000), (n, off, d.numel())
