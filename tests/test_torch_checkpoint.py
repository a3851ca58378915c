"""The port's asynchronous writer (torchmpi_tpu_torch/utils/aio.py over its
own copy of the native executor) and single-file checkpoints
(utils/checkpoint.py) on the CPU; JAX's tests/test_aio.py (its non-sharded
cases) is the spec.

- The writer: round trip, empty and mutable buffers, FIFO order on one
  thread, the errno of a failed write (sticky), no staging litter, close
  draining the queue.
- Checkpoints: ``save_async`` round trip, the same files as ``save``,
  overlapping saves on the FIFO writer, ``latest_step`` /
  ``available_steps``, stale staging files reaped, a template mismatch
  raising ``TemplateMismatchError``.
- Files interchangeable with the JAX package's: a checkpoint written by
  JAX's ``save`` / ``save_async`` restores in the port bit for bit, and the
  port's in JAX's, for a tree of nested dicts and lists with float32,
  bfloat16 and int64 leaves.
"""

import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.utils import checkpoint as jckpt
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.utils import aio, checkpoint

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    jmpi.stop()
    tmpi.stop()
    yield
    tmpi.stop()
    jmpi.stop()


# --- the writer ---------------------------------------------------------------

def test_write_roundtrip(tmp_path):
    p = str(tmp_path / "blob.bin")
    payload = os.urandom(1 << 20)
    with aio.AsyncWriter() as w:
        h = w.submit(p, payload)
        assert h.wait(timeout=30.0) == p
        assert w.bytes_written() == len(payload)
    with open(p, "rb") as f:
        assert f.read() == payload


def test_write_empty_and_bytearray(tmp_path):
    with aio.AsyncWriter() as w:
        h1 = w.submit(str(tmp_path / "empty"), b"")
        ba = bytearray(b"mutable source buffer")
        h2 = w.submit(str(tmp_path / "ba"), ba)
        t = torch.arange(10, dtype=torch.float32)
        h3 = w.submit(str(tmp_path / "t"), t.numpy())
        for h in (h1, h2, h3):
            h.wait(30.0)
    assert os.path.getsize(tmp_path / "empty") == 0
    assert (tmp_path / "ba").read_bytes() == bytes(ba)
    assert (tmp_path / "t").read_bytes() == t.numpy().tobytes()


def test_fifo_last_write_wins(tmp_path):
    """threads=1 executes in submission order: the ordering contract
    save_async's npz-before-metadata commit relies on."""
    p = str(tmp_path / "f")
    with aio.AsyncWriter(threads=1) as w:
        handles = [w.submit(p, f"gen {i}".encode()) for i in range(8)]
        for h in handles:
            h.wait(30.0)
    assert (tmp_path / "f").read_bytes() == b"gen 7"


def test_failure_surfaces_errno(tmp_path):
    with aio.AsyncWriter() as w:
        h = w.submit(str(tmp_path / "no" / "such" / "dir" / "f"), b"x")
        with pytest.raises(OSError) as ei:
            h.wait(30.0)
        assert ei.value.errno == 2  # ENOENT


def test_failure_is_sticky(tmp_path):
    """A failed write keeps failing on re-wait."""
    with aio.AsyncWriter() as w:
        h = w.submit(str(tmp_path / "missing" / "f"), b"x")
        for _ in range(3):
            with pytest.raises(OSError):
                h.wait(30.0)
        assert h.done()


def test_no_tmp_litter_and_atomic_name(tmp_path):
    with aio.AsyncWriter(threads=4) as w:
        hs = [w.submit(str(tmp_path / f"f{i}"), os.urandom(4096))
              for i in range(16)]
        for h in hs:
            h.wait(30.0)
    assert set(os.listdir(tmp_path)) == {f"f{i}" for i in range(16)}


def test_close_drains_pending_writes(tmp_path):
    w = aio.AsyncWriter()
    hs = [w.submit(str(tmp_path / f"d{i}"), os.urandom(1 << 16))
          for i in range(8)]
    w.close()  # drains the queue, does not drop it
    for i in range(8):
        assert os.path.getsize(tmp_path / f"d{i}") == 1 << 16
    for h in hs:
        h.wait(1.0)  # already complete
    with pytest.raises(RuntimeError):
        w.submit(str(tmp_path / "late"), b"x")


# --- checkpoints ----------------------------------------------------------------

def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "opt": {"m": torch.full((5,), 2.5), "step": np.int32(7)}}


def _template():
    return {"w": torch.zeros(3, 4), "opt": {"m": torch.zeros(5),
                                            "step": np.int32(0)}}


def test_checkpoint_save_async_roundtrip(tmp_path):
    h = checkpoint.save_async(str(tmp_path), _tree(), step=3)
    path = h.wait(timeout=60.0)
    assert path.endswith("ckpt_3_p0.npz") and h.done()
    assert checkpoint.latest_step(str(tmp_path)) == 3
    out = checkpoint.restore(str(tmp_path), _template())
    assert torch.equal(out["w"], _tree()["w"])
    assert torch.equal(out["opt"]["m"], _tree()["opt"]["m"])
    assert out["opt"]["step"] == 7


def test_checkpoint_async_matches_sync(tmp_path):
    tree = {"a": torch.from_numpy(
        np.random.RandomState(0).randn(17, 3).astype(np.float32)),
        "h": torch.ones(4, dtype=torch.bfloat16) / 3}
    checkpoint.save(str(tmp_path / "sync"), tree, step=1)
    checkpoint.save_async(str(tmp_path / "async"), tree, step=1).wait(60.0)
    s = np.load(tmp_path / "sync" / "ckpt_1_p0.npz")
    a = np.load(tmp_path / "async" / "ckpt_1_p0.npz")
    assert sorted(s.files) == sorted(a.files) == ["a", "h"]
    for k in s.files:
        assert s[k].dtype == a[k].dtype
        assert s[k].tobytes() == a[k].tobytes()
    assert (tmp_path / "sync" / "ckpt_1_p0.json").read_bytes() == \
        (tmp_path / "async" / "ckpt_1_p0.json").read_bytes()


def test_checkpoint_overlapping_saves(tmp_path):
    """Several steps in flight on the shared FIFO writer; all land."""
    handles = [checkpoint.save_async(
        str(tmp_path), {"x": torch.full((256,), float(s))}, step=s)
        for s in range(5)]
    for h in handles:
        h.wait(60.0)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert checkpoint.available_steps(str(tmp_path)) == [0, 1, 2, 3, 4]
    out = checkpoint.restore(str(tmp_path), {"x": torch.zeros(256)}, step=2)
    assert torch.equal(out["x"], torch.full((256,), 2.0))


def test_no_checkpoint_and_stale_tmp(tmp_path):
    """No step: restore raises FileNotFoundError; a staging file of a dead
    writer older than the reaping age goes at the next save, a live one
    stays."""
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), {"x": torch.zeros(2)})
    old = tmp_path / "ckpt_9_p0.npz.tmp.12345"
    fresh = tmp_path / "ckpt_8_p0.npz.tmp.54321"
    old.write_bytes(b"torn")
    fresh.write_bytes(b"in flight")
    t = time.time() - 2 * checkpoint._TMP_REAP_AGE_S
    os.utime(old, (t, t))
    checkpoint.save(str(tmp_path), {"x": torch.zeros(2)}, step=1)
    assert not old.exists() and fresh.exists()
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_checkpoint_template_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), {"w": torch.zeros(8)}, step=0)
    with pytest.raises(checkpoint.TemplateMismatchError,
                       match="model changed"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(16)})
    with pytest.raises(checkpoint.TemplateMismatchError,
                       match="model changed"):
        checkpoint.restore(str(tmp_path),
                           {"w": torch.zeros(8, dtype=torch.bfloat16)})
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), {"v": torch.zeros(8)})


# --- files interchangeable with the JAX package's -------------------------------

def _np_tree(seed=0):
    r = np.random.RandomState(seed)
    return {"params": {"dense": {"kernel": r.randn(6, 4).astype(np.float32),
                                 "bias": r.randn(4).astype(ml_dtypes.bfloat16)},
                       "blocks": [r.randn(3).astype(np.float32),
                                  {"scale": r.randn(2, 2).astype(
                                      ml_dtypes.bfloat16)}]},
            "step": np.int64(1234567890123),
            "ids": r.randint(-2 ** 40, 2 ** 40, size=5).astype(np.int64)}


def _torch_of(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, t[k]) for k in sorted(t)}
    if isinstance(t, list):
        return [_map(fn, v) for v in t]
    return fn(t)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _flat(t):
    out = []
    _map(out.append, t)
    return out


@pytest.mark.parametrize("save", ["save", "save_async"])
def test_jax_checkpoint_restores_in_port_bitwise(tmp_path, save):
    tree = _np_tree()
    if save == "save":
        jckpt.save(str(tmp_path), tree, step=5)
    else:
        jckpt.save_async(str(tmp_path), tree, step=5).wait(60.0)
    template = _map(lambda a: torch.zeros_like(_torch_of(a)), tree)
    template["step"] = np.int64(0)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    out = checkpoint.restore(str(tmp_path), template)
    assert out["params"]["blocks"][1]["scale"].dtype == torch.bfloat16
    ref = _map(_torch_of, tree)
    ref["step"] = tree["step"]
    for got, want in zip(_flat(out), _flat(ref)):
        gb, wb = _bits(got), _bits(want)
        assert gb[1:] == wb[1:] and gb[0].replace("int16", "bfloat16") == \
            wb[0].replace("int16", "bfloat16")


@pytest.mark.parametrize("save", ["save", "save_async"])
def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, save):
    tree = _np_tree(1)
    ttree = _map(_torch_of, tree)
    ttree["step"] = tree["step"]
    if save == "save":
        checkpoint.save(str(tmp_path), ttree, step=7)
    else:
        checkpoint.save_async(str(tmp_path), ttree, step=7).wait(60.0)
    template = _map(np.zeros_like, tree)
    assert jckpt.latest_step(str(tmp_path)) == 7
    out = jckpt.restore(str(tmp_path), template)
    assert out["params"]["dense"]["bias"].dtype == ml_dtypes.bfloat16
    for got, want in zip(_flat(out), _flat(tree)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    # And the port restores its own file into numpy leaves the same way.
    mine = checkpoint.restore(str(tmp_path), template)
    for got, want in zip(_flat(mine), _flat(tree)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_named_tuple_keys_match_jax(tmp_path):
    """A NamedTuple's fields are ``.<field>`` path names, as JAX's, so the
    port's Adam state restores from a file keyed as JAX keys it."""
    from torchmpi_tpu_torch import optim

    state = optim.adam(1e-3).init(torch.ones(3))
    state = state._replace(mu=torch.full((3,), 0.5))
    checkpoint.save(str(tmp_path), {"opt": state}, step=0)
    assert sorted(np.load(tmp_path / "ckpt_0_p0.npz").files) == \
        ["opt/.count", "opt/.mu", "opt/.nu"]
    out = checkpoint.restore(str(tmp_path), {"opt": optim.adam(1e-3).init(
        torch.zeros(3))})
    assert type(out["opt"]).__name__ == "AdamState"
    assert torch.equal(out["opt"].mu, state.mu) and int(out["opt"].count) \
        == 0
