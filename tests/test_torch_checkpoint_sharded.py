"""The port's sharded checkpoints (``checkpoint.save_sharded`` /
``restore_sharded`` over the ``checkpoint.Sharded`` descriptor) on the CPU;
the sharded cases of JAX's tests/test_aio.py are the spec (:114, :153,
:184, :212, :235): a column-sharded leaf round trip shard by shard with
replicated copies written once, bfloat16 through its bits, a template
mismatch and a layout mismatch raising by name, a torn pair invisible to
``latest_sharded_step``.

Across the packages: JAX's column-sharded ``save_sharded``
(``P(None, ("dcn", "ici"))`` on its 8 CPU devices) restores bitwise into
the port's 8 rank-major shards, and the port's file into JAX's sharding,
with the same npz names, extents and record.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.utils import checkpoint as jckpt
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.utils import checkpoint

from _torch_world import module_group

torch.set_num_threads(2)
Sharded = checkpoint.Sharded


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture(autouse=True)
def fresh():
    tmpi.stop()
    jmpi.stop()
    yield
    tmpi.stop()
    jmpi.stop()


def _columns(w: torch.Tensor, n: int = 8) -> torch.Tensor:
    """``w`` [R, C] as n rank-major column shards [n, R, C / n]."""
    r, c = w.shape
    return w.reshape(r, n, c // n).permute(1, 0, 2).contiguous()


def test_sharded_checkpoint_roundtrip(tmp_path):
    w = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 16)
    b = torch.arange(8, dtype=torch.float32)
    col = Sharded.rank_major(_columns(w), dim=1)
    assert col.shape == (4, 16)
    # Replicated over the 8 ranks: 8 copies of one full-extent shard.
    rep = Sharded((8,), torch.float32, [[(0, 8)]] * 8, shards=[b] * 8)
    tree = {"w": col, "b": rep, "step": np.int32(5)}
    checkpoint.save_sharded(str(tmp_path), tree, step=2)
    assert checkpoint.latest_sharded_step(str(tmp_path)) == 2
    template = {"w": col.template(), "b": rep.template(),
                "step": np.int32(0)}
    out = checkpoint.restore_sharded(str(tmp_path), template)
    assert torch.equal(out["w"].stack(), _columns(w))
    assert out["w"].extents == col.extents
    assert all(torch.equal(s, b) for s in out["b"].shards)
    assert int(out["step"]) == 5
    data = np.load(tmp_path / "shckpt_2_p0.npz")
    assert sum(1 for k in data.files if k.startswith("b//")) == 1
    assert sum(1 for k in data.files if k.startswith("w//")) == 8


def test_checkpoint_bf16_roundtrips(tmp_path):
    w = torch.from_numpy(np.random.RandomState(0).randn(4, 16).astype(
        np.float32)).bfloat16()
    col = Sharded.rank_major(_columns(w), dim=1)
    checkpoint.save_sharded(str(tmp_path), {"w": col}, step=0)
    meta = json.load(open(tmp_path / "shckpt_0_p0.json"))
    assert meta["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "shckpt_0_p0.npz")["w//0"].dtype == "V2"
    out = checkpoint.restore_sharded(str(tmp_path), {"w": col.template()})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].stack(), _columns(w))


def test_checkpoint_template_mismatch_raises(tmp_path):
    x = Sharded.rank_major(torch.zeros(8, 1))
    checkpoint.save_sharded(str(tmp_path), {"w": x}, step=0)
    bad = Sharded.rank_major(torch.zeros(8, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="model changed"):
        checkpoint.restore_sharded(str(tmp_path), {"w": bad.template()})


def test_sharded_latest_step_ignores_torn_pair(tmp_path):
    tree = {"x": torch.ones(8)}
    checkpoint.save_sharded(str(tmp_path), tree, step=1)
    checkpoint.save_sharded(str(tmp_path), tree, step=2)
    os.remove(tmp_path / "shckpt_2_p0.json")  # the crash window
    assert checkpoint.latest_sharded_step(str(tmp_path)) == 1
    out = checkpoint.restore_sharded(str(tmp_path), {"x": torch.zeros(8)})
    assert torch.equal(out["x"], torch.ones(8))


def test_sharded_checkpoint_layout_mismatch_raises(tmp_path):
    w = torch.ones(8, 16)
    checkpoint.save_sharded(
        str(tmp_path), {"w": Sharded.rank_major(_columns(w), dim=1)},
        step=0)
    rows = Sharded.rank_major(w.reshape(8, 1, 16)).template()
    with pytest.raises(ValueError, match="'w'.*different sharding layout"):
        checkpoint.restore_sharded(str(tmp_path), {"w": rows})
    half = Sharded.rank_major(torch.empty(2, 8, 8, device="meta"), dim=1)
    with pytest.raises(ValueError, match="different sharding layout"):
        checkpoint.restore_sharded(str(tmp_path), {"w": half.template()})


def test_descriptor_forms_and_checks():
    st = torch.arange(24.0).reshape(4, 6)
    rm = Sharded.rank_major(st)
    assert rm.shape == (24,) and rm.extents[3] == ((18, 24),)
    loc = Sharded.local(st[1], rank=1, n=4)
    assert loc.shape == (24,) and loc.extents == (((6, 12),),)
    assert loc.template().shards is None
    with pytest.raises(ValueError, match="extents"):
        Sharded((4,), torch.float32, [[(0, 5)]])
    with pytest.raises(ValueError, match="does not match"):
        Sharded((4,), torch.float32, [[(0, 2)]], shards=[torch.zeros(3)])
    with pytest.raises(ValueError, match="template holds no"):
        rm.template().stack()


# --- across the packages --------------------------------------------------------

def _jax_mesh():
    """The JAX package's flat 8-device runtime: (mesh, the column
    sharding, the replicated sharding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmpi.init(jmpi.Config(dcn_size=1))
    return (mesh, NamedSharding(mesh, P(None, ("dcn", "ici"))),
            NamedSharding(mesh, P()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_sharded_restores_in_port(tmp_path, dtype):
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    w = np.random.RandomState(1).randn(4, 16).astype(dt)
    b = np.arange(8, dtype=np.float32)
    import jax

    _, sh_col, sh_rep = _jax_mesh()
    jckpt.save_sharded(str(tmp_path), {
        "w": jax.device_put(w, sh_col), "b": jax.device_put(b, sh_rep),
        "step": np.int32(5)}, step=3)
    jmpi.stop()
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    wt = torch.from_numpy(w.view(np.int16)).view(tdt) \
        if dtype == "bfloat16" else torch.from_numpy(w)
    template = {"w": Sharded.rank_major(
        torch.empty(8, 4, 2, dtype=tdt, device="meta"), dim=1).template(),
        "b": torch.zeros(8), "step": np.int32(0)}
    out = checkpoint.restore_sharded(str(tmp_path), template)
    assert torch.equal(out["w"].stack(), _columns(wt))
    assert torch.equal(out["b"], torch.from_numpy(b))
    assert int(out["step"]) == 5


def test_port_sharded_restores_in_jax(tmp_path):
    w = np.random.RandomState(2).randn(4, 16).astype(ml_dtypes.bfloat16)
    m = np.random.RandomState(3).randn(16).astype(np.float32)
    wt = torch.from_numpy(w.view(np.int16)).view(torch.bfloat16)
    checkpoint.save_sharded(str(tmp_path), {
        "w": Sharded.rank_major(_columns(wt), dim=1),
        "m": Sharded.rank_major(torch.from_numpy(m).reshape(8, 2)),
        "b": torch.arange(8, dtype=torch.float32)}, step=4)
    meta = json.load(open(tmp_path / "shckpt_4_p0.json"))
    assert meta["leaves"]["w"]["shards"][1] == {
        "extents": [[0, 4], [2, 4]], "name": "w//1"}
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh, sh_col, sh_rep = _jax_mesh()
    sh_flat = NamedSharding(mesh, P(("dcn", "ici")))
    template = {"w": jax.ShapeDtypeStruct((4, 16), jnp.bfloat16,
                                          sharding=sh_col),
                "m": jax.ShapeDtypeStruct((16,), jnp.float32,
                                          sharding=sh_flat),
                "b": jax.ShapeDtypeStruct((8,), jnp.float32,
                                          sharding=sh_rep)}
    out = jckpt.restore_sharded(str(tmp_path), template)
    assert np.asarray(out["w"]).tobytes() == w.tobytes()
    assert np.asarray(out["m"]).tobytes() == m.tobytes()
    assert np.asarray(out["b"]).tobytes() == \
        np.arange(8, dtype=np.float32).tobytes()
