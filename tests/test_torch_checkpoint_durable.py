"""The port's durable checkpoints (torchmpi_tpu_torch/utils/durable.py and
the utils/checkpoint.py seams) on the CPU; JAX's
tests/test_checkpoint_durable.py is the spec, one port case for each of
its 23: the ``ckpt_*`` config, ``.tmp`` artifacts invisible to the step
listings, the ``ckpt.write`` / ``ckpt.read`` fault sites (torn, ENOSPC,
silent bit-rot), digests over save / save_async / save_sharded, buddy
repair bit-identical to the primary, the walk-back past a corrupt newest
step with its reason, keep-last-K retention that never prunes the
protected step, ``replicate_for``, the chaos tool on the ``ckpt.*`` sites.

Across the packages: a durable checkpoint saved by the JAX package's flat
8-device runtime restores bitwise in the port, repaired from JAX's buddy
after its primary rotted, and the other way round; ``digest_bytes``
and ``digest`` give JAX's hex digests; one fault plan gives the same
``ckpt.*`` decisions and the same ``tm_ckpt_*`` events in both packages.
The writer fence (``faults/fencing.py``) refuses a stale save (a stub
board, as JAX's tests/test_hotstate.py:298-313 builds one).  With
``ckpt_redundancy="off"``, no plan and no fence, a subprocess probe saves
and restores in every form and imports none of the durable layer.
"""

import errno
import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.utils import checkpoint as jckpt
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.utils import checkpoint, restart

from _torch_world import module_group

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


def _write_plan(path, rules, seed=7):
    with open(path, "w") as f:
        json.dump({"version": 1, "seed": seed, "rules": rules}, f)
    return str(path)


def _reset_faults():
    for name in ("torchmpi_tpu_torch.faults", "torchmpi_tpu.faults"):
        if name in sys.modules:
            sys.modules[name].reset()


@pytest.fixture()
def durable_runtime(tmp_path):
    """Callable fixture: arm the port's runtime (CPU, a world of one) with
    durable checkpoints on, optionally under a fault plan."""
    counter = [0]

    def arm(rules=None, *, redundancy="buddy", seed=7, **cfg_kw):
        counter[0] += 1
        kw = dict(ckpt_redundancy=redundancy)
        if rules is not None:
            kw["faults"] = _write_plan(
                tmp_path / f"plan{counter[0]}.json", rules, seed=seed)
        kw.update(cfg_kw)
        tmpi.stop()
        return tmpi.init(device="cpu", **kw)

    yield arm
    _reset_faults()
    tmpi.stop()


def _tree():
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": np.float32(3.5)}


def _rot(path, offset=60):
    raw = bytearray(open(path, "rb").read())
    raw[offset % len(raw)] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(raw))


# --- config -----------------------------------------------------------------

def test_ckpt_config_normalization_env_and_validation(monkeypatch):
    tmpi.stop()
    tmpi.init(device="cpu", ckpt_redundancy="on")  # -> buddy
    assert tmpi.config().ckpt_redundancy == "buddy"
    with pytest.raises(ValueError, match="ckpt_redundancy"):
        tmpi.set_config(ckpt_redundancy="sideways")
    with pytest.raises(ValueError, match="ckpt_buddies"):
        tmpi.set_config(ckpt_buddies=0)
    with pytest.raises(ValueError, match="ckpt_keep"):
        tmpi.set_config(ckpt_keep=-1)
    tmpi.set_config(ckpt_redundancy="verify", ckpt_keep=3)
    assert tmpi.config().ckpt_redundancy == "verify"
    tmpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_CKPT_REDUNDANCY", "buddy")
    monkeypatch.setenv("TORCHMPI_TPU_CKPT_KEEP", "5")
    tmpi.init(tmpi.Config(), device="cpu")  # explicit Config, env pickup
    assert tmpi.config().ckpt_redundancy == "buddy"
    assert tmpi.config().ckpt_keep == 5
    tmpi.stop()
    monkeypatch.delenv("TORCHMPI_TPU_CKPT_REDUNDANCY")
    with pytest.raises(ValueError, match="ckpt_redundancy"):
        tmpi.init(tmpi.Config(ckpt_redundancy="banana"), device="cpu")
    tmpi.stop()


# --- crash-mid-save artifacts -------------------------------------------------

def test_tmp_artifacts_invisible_to_step_listing(tmp_path):
    tmpi.stop()
    d = str(tmp_path)
    checkpoint.save(d, _tree(), step=4)
    (tmp_path / "ckpt_9_p0.npz.tmp").write_bytes(b"PK\x03\x04 half")
    (tmp_path / "ckpt_9_p0.json.tmp").write_bytes(b'{"step"')
    (tmp_path / "shckpt_9_p0.npz.tmp").write_bytes(b"PK")
    assert checkpoint.latest_step(d) == 4
    assert checkpoint.available_steps(d) == [4]
    assert checkpoint.latest_sharded_step(d) is None
    assert not [f for f in os.listdir(d)
                if f.startswith("ckpt_4") and ".tmp" in f]
    meta = json.load(open(tmp_path / "ckpt_4_p0.json"))
    assert meta["step"] == 4 and "dtypes" in meta


def test_torn_write_leaves_ignored_artifact(tmp_path, durable_runtime):
    durable_runtime([{"site": "ckpt.write", "kind": "torn",
                      "max_hits": 1}], redundancy="off")
    d = str(tmp_path / "ck")
    with pytest.raises(OSError, match="torn"):
        checkpoint.save(d, _tree(), step=5)
    assert [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert checkpoint.latest_step(d) is None
    assert checkpoint.available_steps(d) == []
    checkpoint.save(d, _tree(), step=5)  # the one hit is spent
    assert checkpoint.latest_step(d) == 5


def test_ckpt_write_fail_is_enospc_flavored(tmp_path, durable_runtime):
    durable_runtime([{"site": "ckpt.write", "kind": "fail",
                      "max_hits": 1}], redundancy="off")
    with pytest.raises(OSError) as ei:
        checkpoint.save(str(tmp_path / "ck"), _tree(), step=1)
    assert ei.value.errno == errno.ENOSPC


# --- digest round trips ---------------------------------------------------------

def test_digest_roundtrip_save(tmp_path, durable_runtime):
    durable_runtime(redundancy="verify")
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save(d, tree, step=2)
    meta = json.load(open(tmp_path / "ckpt_2_p0.json"))
    assert len(meta["digest"]) == 32  # blake2b-16 hex
    out = checkpoint.restore(d, tree)
    assert torch.equal(out["w"], tree["w"])
    _rot(str(tmp_path / "ckpt_2_p0.npz"))
    with pytest.raises(checkpoint.CheckpointCorruptError, match="corrupt"):
        checkpoint.restore(d, tree)


def test_digest_roundtrip_save_async(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save_async(d, tree, step=3).wait(timeout=60.0)
    assert "digest" in json.load(open(tmp_path / "ckpt_3_p0.json"))
    buddy = tmp_path / "buddies" / "r0" / "ckpt_3_p0.npz"
    assert buddy.read_bytes() == (tmp_path / "ckpt_3_p0.npz").read_bytes()
    out = checkpoint.restore(d, tree)
    assert torch.equal(out["w"], tree["w"])


def test_digest_roundtrip_save_sharded(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    x = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    checkpoint.save_sharded(d, {"x": checkpoint.Sharded.rank_major(x)},
                            step=4)
    meta = json.load(open(tmp_path / "shckpt_4_p0.json"))
    assert "digest" in meta and "leaves" in meta
    tmpl = {"x": checkpoint.Sharded.rank_major(x).template()}
    assert torch.equal(checkpoint.restore_sharded(d, tmpl)["x"].stack(), x)
    # A corrupt newest step (primary and buddy): the one-participant pick
    # walks back to the older step that verifies.
    checkpoint.save_sharded(
        d, {"x": checkpoint.Sharded.rank_major(x * 2)}, step=8)
    _rot(str(tmp_path / "shckpt_8_p0.npz"))
    _rot(str(tmp_path / "buddies" / "r0" / "shckpt_8_p0.npz"))
    assert torch.equal(checkpoint.restore_sharded(d, tmpl)["x"].stack(), x)


# --- buddy repair ---------------------------------------------------------------

def test_buddy_repair_bit_identical(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save(d, tree, step=7)
    primary = tmp_path / "ckpt_7_p0.npz"
    orig = primary.read_bytes()
    _rot(str(primary))
    out = checkpoint.restore(d, tree)  # verify_failed -> repair
    assert torch.equal(out["w"], tree["w"])
    assert primary.read_bytes() == orig
    # The primary pair deleted outright: the storage-died flavor.
    os.remove(primary)
    os.remove(str(tmp_path / "ckpt_7_p0.json"))
    out = checkpoint.restore(d, tree, step=7)
    assert torch.equal(out["w"], tree["w"])
    assert primary.read_bytes() == orig


def test_buddy_vouches_or_vetoes_digestless_primary(tmp_path,
                                                    durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save(d, tree, step=7)
    primary = tmp_path / "ckpt_7_p0.npz"
    meta_path = tmp_path / "ckpt_7_p0.json"
    orig = primary.read_bytes()
    os.remove(meta_path)  # vouch: the json re-seeded from the buddy
    out = checkpoint.restore(d, tree, step=7)
    assert torch.equal(out["w"], tree["w"])
    assert "digest" in json.load(open(meta_path))
    os.remove(meta_path)  # veto: json lost and npz rotted
    _rot(str(primary))
    out = checkpoint.restore(d, tree, step=7)
    assert torch.equal(out["w"], tree["w"])
    assert primary.read_bytes() == orig


def test_replicate_for_survives_metaless_source(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    checkpoint.save(d, _tree(), step=5)
    os.remove(str(tmp_path / "ckpt_5_p0.json"))
    os.remove(str(tmp_path / "buddies" / "r0" / "ckpt_5_p0.json"))
    checkpoint.replicate_for(d, 5, [2], src_proc=0)
    assert (tmp_path / "ckpt_5_p2.npz").read_bytes() == \
        (tmp_path / "ckpt_5_p0.npz").read_bytes()
    assert "digest" in json.load(open(tmp_path / "ckpt_5_p2.json"))


def test_buddy_exhausted_raises_typed(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    checkpoint.save(d, _tree(), step=7)
    _rot(str(tmp_path / "ckpt_7_p0.npz"))
    _rot(str(tmp_path / "buddies" / "r0" / "ckpt_7_p0.npz"))
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(d, _tree(), step=7)


def test_bitrot_read_detected_and_repaired_with_counters(
        tmp_path, durable_runtime):
    durable_runtime(rules=None, redundancy="buddy")
    d = str(tmp_path / "ck")
    tree = _tree()
    checkpoint.save(d, tree, step=9)  # saved clean (no plan yet)
    durable_runtime([{"site": "ckpt.read", "kind": "corrupt_silent",
                      "max_hits": 1}], redundancy="buddy",
                    obs="metrics", obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    obs.reset()
    try:
        out = checkpoint.restore(d, tree, step=9)
        assert torch.equal(out["w"], tree["w"])
        reg = obs.registry()
        assert reg.counter("tm_ckpt_verify_failed_total",
                           reason="primary") == 1
        assert reg.counter("tm_ckpt_repaired_total", reason="buddy_r0") == 1
        ev = [e for e in obs.recorder().events() if e[2] == "ckpt"]
        assert any(e[6] == "verify_failed" for e in ev)
        assert any(e[6] == "repaired" for e in ev)
    finally:
        obs.deactivate()
        obs.reset()


def test_off_mode_bitrot_fails_or_diverges(tmp_path, durable_runtime):
    durable_runtime(rules=None, redundancy="buddy")
    d = str(tmp_path / "ck")
    tree = _tree()
    checkpoint.save(d, tree, step=9)
    durable_runtime([{"site": "ckpt.read", "kind": "corrupt_silent",
                      "max_hits": 1}], redundancy="off")
    try:
        out = checkpoint.restore(d, tree, step=9)
        assert not torch.equal(out["w"], tree["w"])  # garbage
    except checkpoint.CheckpointCorruptError:
        pytest.fail("off mode must not run the digest check")
    except Exception:
        pass  # the zip CRC tripped: "fails" is an accepted outcome


# --- recovery walk-back evidence ----------------------------------------------

def test_walkback_past_corrupt_newest_with_reason(tmp_path,
                                                  durable_runtime):
    durable_runtime(redundancy="buddy", obs="metrics",
                    obs_dir=str(tmp_path / "obs"))
    from torchmpi_tpu_torch import obs

    obs.reset()
    d = str(tmp_path / "ck")
    tree = _tree()
    try:
        checkpoint.save(d, tree, step=10)
        checkpoint.save(d, {"w": tree["w"] * 2, "b": np.float32(9)},
                        step=20)
        _rot(os.path.join(d, "ckpt_20_p0.npz"))
        _rot(os.path.join(d, "buddies", "r0", "ckpt_20_p0.npz"))
        state, step = restart.recover(_tree, d, tree)
        assert step == 10
        assert torch.equal(state["w"], tree["w"])
        assert obs.registry().counter("tm_ckpt_walkback_total",
                                      reason="corrupt") >= 1
        assert checkpoint.protected_step(d) == 10
    finally:
        obs.deactivate()
        obs.reset()


def test_walkback_reason_classification():
    wr = checkpoint.walkback_reason
    assert wr(checkpoint.CheckpointCorruptError("p")) == "corrupt"
    assert wr(checkpoint.TemplateMismatchError("shape")) == \
        "template_mismatch"
    assert wr(FileNotFoundError("gone")) == "missing"
    assert wr(KeyError("k")) == "missing"
    assert wr(ValueError("bad zip")) == "corrupt"
    assert wr(OSError("io")) == "corrupt"
    assert wr(RuntimeError("x")) == "RuntimeError"


def test_recover_records_template_mismatch(tmp_path, monkeypatch):
    tmpi.stop()
    d = str(tmp_path)
    checkpoint.save(d, _tree(), step=3)
    checkpoint.save(d, {"w": torch.zeros(2, 2), "b": np.float32(0)},
                    step=6)  # the wrong shape
    events = []
    monkeypatch.setattr(
        "torchmpi_tpu_torch.utils.telemetry.emit",
        lambda m, *a, **k: events.append((m, a, k)))
    _, step = restart.recover(_tree, d, _tree())
    assert step == 3
    assert ("record_ckpt", ("walkback",),
            {"step": 6, "reason": "template_mismatch"}) in events


# --- retention ------------------------------------------------------------------

def test_retention_keeps_last_k_and_protected(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy", ckpt_keep=2)
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        checkpoint.save(d, _tree(), step=s)
    assert checkpoint.available_steps(d) == [3, 4]
    assert not os.path.exists(
        os.path.join(d, "buddies", "r0", "ckpt_2_p0.npz"))
    checkpoint.protect_step(d, 3)
    checkpoint.save(d, _tree(), step=5)
    checkpoint.save(d, _tree(), step=6)
    assert checkpoint.available_steps(d) == [3, 5, 6]
    assert os.path.exists(os.path.join(d, "buddies", "r0", "ckpt_3_p0.npz"))


def test_async_retention_prunes_after_durability(tmp_path,
                                                 durable_runtime):
    durable_runtime(redundancy="buddy", ckpt_keep=2)
    d = str(tmp_path)
    handles = [checkpoint.save_async(d, _tree(), step=s)
               for s in (1, 2, 3, 4)]
    for h in handles:
        h.wait(timeout=60.0)
    assert checkpoint.available_steps(d) == [3, 4]
    assert not os.path.exists(
        os.path.join(d, "buddies", "r0", "ckpt_1_p0.npz"))


def test_restore_sharded_torn_json_is_typed_corrupt(tmp_path,
                                                    durable_runtime):
    durable_runtime(redundancy="verify")
    d = str(tmp_path)
    x = checkpoint.Sharded.rank_major(torch.arange(16.0).reshape(8, 2))
    checkpoint.save_sharded(d, {"x": x}, step=2)
    (tmp_path / "shckpt_2_p0.json").write_text("{ torn")
    with pytest.raises(checkpoint.CheckpointCorruptError, match="metadata"):
        checkpoint.restore_sharded(d, {"x": x.template()}, step=2)


# --- the dead rank's storage ---------------------------------------------------

def test_shrink_recovers_agreed_step_after_storage_death(
        tmp_path, durable_runtime):
    """Every primary of the agreed step gone with a crash: recovery
    repairs it from the buddy copies, and the final state is bitwise the
    uninterrupted run's."""
    durable_runtime(redundancy="buddy")
    d = str(tmp_path / "ck")

    def init_fn():
        return {"w": torch.zeros(4)}

    def step(state, i):
        return {"w": state["w"] + (i + 1)}

    crashed = []

    def flaky(state, i):
        if i == 5 and not crashed:
            crashed.append(i)
            for f in os.listdir(d):
                if f.startswith("ckpt_") and f.endswith((".npz", ".json")):
                    os.remove(os.path.join(d, f))
            raise RuntimeError("injected crash + storage death")
        return step(state, i)

    final, info = restart.run_with_restarts(
        init_fn, flaky, steps=8, directory=d, save_every=2)
    assert info["restarts_used"] == 1 and info["recovered_step"] == 4
    exp = init_fn()
    for i in range(8):
        exp = step(exp, i)
    assert torch.equal(final["w"], exp["w"])


def test_replicate_for_repairs_rotted_source(tmp_path, durable_runtime):
    durable_runtime(redundancy="buddy")
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save(d, tree, step=12)
    orig = (tmp_path / "ckpt_12_p0.npz").read_bytes()
    _rot(str(tmp_path / "ckpt_12_p0.npz"))
    checkpoint.replicate_for(d, 12, [2, 3], src_proc=0)
    for r in (2, 3):
        assert (tmp_path / f"ckpt_12_p{r}.npz").read_bytes() == orig
        assert "digest" in json.load(open(tmp_path / f"ckpt_12_p{r}.json"))
    # Off mode: the plain tmp + rename copy.
    tmpi.stop()
    tmpi.init(device="cpu")
    d2 = str(tmp_path / "plain")
    checkpoint.save(d2, tree, step=1)
    checkpoint.replicate_for(d2, 1, [4])
    assert os.path.exists(os.path.join(d2, "ckpt_1_p4.npz"))


def test_replicate_for_races_keep_last_k_retention(tmp_path,
                                                   durable_runtime):
    """Seeding a joiner at an old agreed step survives a keep-last-K
    horizon past it: replicate_for writes with no prune pass."""
    durable_runtime(redundancy="buddy", ckpt_keep=2)
    from torchmpi_tpu_torch.utils import durable

    d = str(tmp_path)
    tree = _tree()
    for s in (3, 5, 6, 7, 8):
        checkpoint.save(d, tree, step=s)
    assert checkpoint.available_steps(d) == [7, 8]
    for s in (7, 8):
        checkpoint.replicate_for(d, s, [2], src_proc=0)
    checkpoint.protect_step(d, 3)
    checkpoint.save(d, tree, step=3)
    checkpoint.replicate_for(d, 3, [2], src_proc=0)
    for s in (3, 7, 8):
        assert os.path.exists(os.path.join(d, f"ckpt_{s}_p2.npz")), s
        _, meta = durable.read_pair(d, f"ckpt_{s}_p2", step=s, proc=2)
        assert meta["step"] == s
        for h in durable.buddy_holders(2):
            assert os.path.exists(os.path.join(
                durable.buddy_dir(d, h), f"ckpt_{s}_p2.npz")), (s, h)
    checkpoint.save(d, tree, step=9)
    assert checkpoint.available_steps(d) == [3, 8, 9]


# --- the chaos tool on the ckpt sites --------------------------------------------

def test_chaos_tool_ckpt_sites(tmp_path, capsys):
    from torchmpi_tpu_torch.faults import tool

    out = str(tmp_path / "plan.json")
    assert tool.main(["gen", "--out", out, "--seed", "3",
                      "--rule", "ckpt.read:corrupt_silent:1.0:1",
                      "--rule", "ckpt.write:torn:1.0:1"]) == 0
    assert tool.main(["lint", out]) == 0
    bad = str(tmp_path / "bad.json")
    assert tool.main(["gen", "--out", bad, "--rule", "ckpt.read:torn"]) == 0
    assert tool.main(["lint", bad]) == 1  # torn needs ckpt.write
    assert "torn" in capsys.readouterr().out
    dump = tmp_path / "metrics_host0.jsonl"
    dump.write_text(json.dumps(
        {"kind": "counter", "name": "tm_ckpt_repaired_total",
         "labels": {"reason": "buddy_r1"}, "value": 2}) + "\n")
    assert tool.main(["summarize", str(dump)]) == 0
    assert "ckpt_repaired" in capsys.readouterr().out


# --- the writer fence ----------------------------------------------------------

class _View:
    def __init__(self, epoch):
        self.epoch = epoch


class _Board:
    """A stub membership board: ``committed_view()`` and ``fence``."""

    fence = None

    def __init__(self, epoch=None):
        self.epoch = epoch

    def committed_view(self):
        return None if self.epoch is None else _View(self.epoch)


def test_fence_rejects_stale_checkpoint_save(tmp_path):
    """A zombie writer's save (sync, async and sharded) raises the typed
    error before any byte lands; adopting the committed epoch restores
    writability, and disarming retracts the seam (JAX
    tests/test_partition.py::test_fence_rejects_stale_checkpoint_save)."""
    tmpi.stop()
    from torchmpi_tpu_torch.faults import fencing

    board = _Board()
    fence = fencing.arm(board, 0, epoch=1)
    try:
        assert board.fence is fence and fencing.current() is fence
        board.epoch = 2  # a majority committed a newer view
        d = str(tmp_path / "ckpt")
        state = {"w": torch.arange(6, dtype=torch.float32)}
        with pytest.raises(fencing.FencedWriterError) as ei:
            checkpoint.save(d, state, step=5)
        assert ei.value.writer_epoch == 1 and ei.value.committed_epoch == 2
        with pytest.raises(fencing.FencedWriterError):
            checkpoint.save_async(d, state, step=5)
        with pytest.raises(fencing.FencedWriterError):
            checkpoint.save_sharded(d, state, step=5)
        assert checkpoint.latest_step(d) is None  # nothing landed
        fence.check(epoch=-1)  # the no-view beacon is exempt
        fence.update(2)
        checkpoint.save(d, state, step=5)
        assert checkpoint.latest_step(d) == 5
    finally:
        fencing.disarm()
    assert board.fence is None and fencing.current() is None
    checkpoint.save(d, state, step=6)
    assert checkpoint.latest_step(d) == 6


# --- across the packages --------------------------------------------------------

def _jtree():
    rs = np.random.RandomState(3)
    return {"w": rs.randn(8, 8).astype(np.float32),
            "h": rs.randn(4, 6).astype(ml_dtypes.bfloat16),
            "n": {"i": np.arange(5, dtype=np.int64), "b": np.float32(2.5)}}


def _ttemplate(jt):
    return {"w": torch.zeros(8, 8), "h": torch.zeros(4, 6,
                                                     dtype=torch.bfloat16),
            "n": {"i": torch.zeros(5, dtype=torch.int64),
                  "b": np.float32(0)}}


def _tensor_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _equal_bits(t, a):
    if isinstance(t, torch.Tensor):
        return torch.equal(t, _tensor_of(np.asarray(a)))
    return np.asarray(t).tobytes() == np.asarray(a).tobytes()


@pytest.mark.parametrize("save_fn", ["save", "save_async"])
def test_jax_durable_checkpoint_restores_and_repairs_in_port(tmp_path,
                                                             save_fn):
    """A buddy checkpoint saved by the JAX package's flat 8-device runtime
    restores bitwise in the port; with its primary rotted the port
    repairs it from JAX's buddy bit-identically."""
    d = str(tmp_path)
    jt = _jtree()
    tmpi.stop()
    jmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, ckpt_redundancy="buddy"))
    try:
        if save_fn == "save":
            jckpt.save(d, jt, step=4)
        else:
            jckpt.save_async(d, jt, step=4).wait(60.0)
    finally:
        jmpi.stop()
    tmpi.init(device="cpu", ckpt_redundancy="buddy")
    tmpl = _ttemplate(jt)
    out = checkpoint.restore(d, tmpl)
    for k in ("w", "h"):
        assert _equal_bits(out[k], jt[k]), k
    assert _equal_bits(out["n"]["i"], jt["n"]["i"])
    assert _equal_bits(out["n"]["b"], jt["n"]["b"])
    primary = tmp_path / "ckpt_4_p0.npz"
    orig = primary.read_bytes()
    _rot(str(primary))
    out = checkpoint.restore(d, tmpl, step=4)
    assert _equal_bits(out["h"], jt["h"]) and _equal_bits(out["w"], jt["w"])
    assert primary.read_bytes() == orig
    tmpi.stop()


def test_port_durable_checkpoint_restores_and_repairs_in_jax(tmp_path):
    d = str(tmp_path)
    jt = _jtree()
    tt = {"w": _tensor_of(jt["w"]), "h": _tensor_of(jt["h"]),
          "n": {"i": _tensor_of(jt["n"]["i"]), "b": jt["n"]["b"]}}
    tmpi.stop()
    tmpi.init(device="cpu", ckpt_redundancy="buddy")
    checkpoint.save(d, tt, step=6)
    tmpi.stop()
    jmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, ckpt_redundancy="buddy"))
    try:
        tmpl = {"w": np.zeros((8, 8), np.float32),
                "h": np.zeros((4, 6), ml_dtypes.bfloat16),
                "n": {"i": np.zeros(5, np.int64), "b": np.float32(0)}}
        out = jckpt.restore(d, tmpl)
        for k in ("w", "h"):
            assert np.asarray(out[k]).tobytes() == jt[k].tobytes(), k
        primary = tmp_path / "ckpt_6_p0.npz"
        orig = primary.read_bytes()
        _rot(str(primary))
        out = jckpt.restore(d, tmpl, step=6)
        assert np.asarray(out["h"]).tobytes() == jt["h"].tobytes()
        assert primary.read_bytes() == orig
        # Retention across the packages: JAX prunes the port's files.
        jmpi.set_config(ckpt_keep=1)
        jckpt.save(d, tmpl, step=7)
        assert jckpt.available_steps(d) == [7]
        assert not (tmp_path / "buddies" / "r0" / "ckpt_6_p0.npz").exists()
    finally:
        jmpi.stop()


def test_digests_match_jax():
    from torchmpi_tpu.faults import integrity as jint
    from torchmpi_tpu_torch.faults import integrity

    raw = os.urandom(4097)
    assert integrity.digest_bytes(raw) == jint.digest_bytes(raw)
    assert integrity.DIGEST_BYTES == jint.DIGEST_BYTES == 16
    rs = np.random.RandomState(0)
    for a in (rs.randn(7, 3).astype(np.float32),
              rs.randn(5).astype(ml_dtypes.bfloat16),
              np.arange(12, dtype=np.int64).reshape(3, 4)):
        t = _tensor_of(a)
        assert integrity.digest(t) == integrity.digest(a) == jint.digest(a)
    # Not C-contiguous: the bytes of the values, as numpy hashes them.
    a = rs.randn(4, 6).astype(np.float32)
    assert integrity.digest(torch.from_numpy(a).t()) == jint.digest(a.T)
    assert integrity.verify("x", a, jint.digest(a)) == jint.digest(a)
    with pytest.raises(integrity.IntegrityError) as ei:
        integrity.verify("x", a + 1, jint.digest(a))
    assert ei.value.transient


def test_same_plan_same_ckpt_events_in_both_packages(tmp_path,
                                                     monkeypatch):
    """One plan (rot at the first ckpt.write, step 1's primary npz; a
    torn write at step 3's; rot at the third ckpt.read, step 2's primary)
    through the same saves and restores in each package: the same fired
    decisions and the same tm_ckpt_* events."""
    rules = [{"site": "ckpt.write", "kind": "corrupt_silent",
              "max_hits": 1},
             {"site": "ckpt.write", "kind": "torn", "after": 8,
              "max_hits": 1},
             {"site": "ckpt.read", "kind": "corrupt_silent", "after": 2,
              "max_hits": 1}]
    plan = _write_plan(tmp_path / "plan.json", rules, seed=11)
    jt = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}

    def drive(mod, ckpt, tree, tmpl, d):
        events = []
        p = mod.faults.plan()
        decide = p.decide

        def traced(site):
            got = decide(site)
            if got is not None:
                events.append((site, got[1], got[0].kind))
            return got

        p.decide = traced
        monkeypatch.setattr(
            f"{mod.__name__}.utils.telemetry.emit",
            lambda m, *a, **k: events.append((m, a, tuple(sorted(
                k.items())))) if m == "record_ckpt" else None)
        ckpt.save(d, tree, step=1)   # writes 0-3: the primary npz rots
        ckpt.save(d, tree, step=2)   # writes 4-7
        try:  # write 8, the primary npz, is torn
            ckpt.save(d, tree, step=3)
        except OSError as e:
            events.append(("raised", e.errno))
        out = ckpt.restore(d, tmpl, step=1)   # reads 0-1: disk rot repaired
        out2 = ckpt.restore(d, tmpl, step=2)  # reads 2-3: read rot repaired
        return events, out, out2

    tmpi.stop()
    jmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, ckpt_redundancy="buddy",
                          faults=plan))
    try:
        jev, jout, jout2 = drive(jmpi, jckpt, jt,
                                 {"w": np.zeros((8, 8), np.float32)},
                                 str(tmp_path / "jax"))
    finally:
        _reset_faults()
        jmpi.stop()
    tmpi.init(device="cpu", ckpt_redundancy="buddy", faults=plan)
    try:
        tev, tout, tout2 = drive(tmpi, checkpoint,
                                 {"w": torch.from_numpy(jt["w"])},
                                 {"w": torch.zeros(8, 8)},
                                 str(tmp_path / "port"))
    finally:
        _reset_faults()
        tmpi.stop()
    assert tev == jev
    assert ("raised", errno.EIO) in tev
    assert any(e[:2] == ("record_ckpt", ("repaired",)) for e in tev)
    for o in (tout, tout2):
        assert o["w"].numpy().tobytes() == jt["w"].tobytes()
    for o in (jout, jout2):
        assert np.asarray(o["w"]).tobytes() == jt["w"].tobytes()


# --- off means off -------------------------------------------------------------

def test_off_mode_never_imports_the_durable_layer(tmp_path):
    """A save, a save_async and a save_sharded and their restores with
    ``ckpt_redundancy="off"``, no plan and no fence: the durable module,
    the integrity and fencing modules and the fault layer stay out of
    ``sys.modules``."""
    probe = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_REPO!r})
        import torch
        import torchmpi_tpu_torch as tmpi
        from torchmpi_tpu_torch.utils import checkpoint, restart
        tmpi.init(device="cpu")
        assert tmpi.config().ckpt_redundancy == "off"
        d = {str(tmp_path)!r}
        tree = {{"w": torch.arange(6.0), "h": torch.ones(2, dtype=torch.bfloat16)}}
        checkpoint.save(d, tree, step=1)
        checkpoint.save_async(d, tree, step=2).wait(60.0)
        sh = {{"m": checkpoint.Sharded.rank_major(torch.arange(8.0).reshape(4, 2))}}
        checkpoint.save_sharded(d, sh, step=3)
        assert torch.equal(checkpoint.restore(d, tree, step=1)["h"], tree["h"])
        assert torch.equal(checkpoint.restore(d, tree)["w"], tree["w"])
        got = checkpoint.restore_sharded(d, {{"m": sh["m"].template()}})
        assert torch.equal(got["m"].stack(), sh["m"].stack())
        restart.recover(lambda: tree, d, tree)
        bad = [m for m in ("torchmpi_tpu_torch.utils.durable",
                           "torchmpi_tpu_torch.faults.integrity",
                           "torchmpi_tpu_torch.faults.fencing",
                           "torchmpi_tpu_torch.faults",
                           "torchmpi_tpu_torch.watchdog")
               if m in sys.modules]
        assert not bad, bad
        assert not [m for m in sys.modules if m.startswith("torchmpi_tpu.")
                    or m == "torchmpi_tpu" or m.startswith("jax")]
        tmpi.stop()
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TORCHMPI_TPU_")}
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
