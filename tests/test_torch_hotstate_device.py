"""The hot-state tier's delta pack on the card (torchmpi_tpu_torch/hotstate/:
``_pack_delta`` runs its torch ops on the card for leaves there) against
its plain version, the numpy pack of the same leaves on the host: byte for
byte, on random leaves of each dtype (float32, float16, float64, bfloat16
raw, int32 raw, an empty leaf), with a zero delta, an all-changed delta,
and NaN and +-inf entries in both the new leaves and the base.  Also the
snapshot pack, and the restore of a card template back onto the card.

Card-only: every test is marked ``gpu`` and skips without a CUDA card (no
JAX here: the numpy pack is the JAX package's arithmetic, held to it by
tests/test_torch_hotstate.py).
"""

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch import hotstate

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pack on the card has no CPU "
                    "mode here: CPU tensors take the numpy pack)")
    return torch.device("cuda")


def _leaves(seed, dev, shapes=((257, 129), (4099,), (33, 7), (0, 5), (3,),
                               (61,), (8,))):
    g = torch.Generator().manual_seed(seed)
    f32 = torch.randn(shapes[0], generator=g) * 3
    f16 = (torch.randn(shapes[1], generator=g) * 0.1).half()
    f64 = torch.randn(shapes[2], generator=g, dtype=torch.float64)
    empty = torch.zeros(shapes[3])
    bf16 = torch.randn(shapes[5], generator=g).bfloat16()
    ints = torch.randint(-50, 50, shapes[6], generator=g, dtype=torch.int32)
    return [t.to(dev) for t in (f32, f16, f64, empty, bf16, ints,
                                torch.tensor(seed, dtype=torch.int64))]


def _bytes(t) -> bytes:
    return hotstate._host(t).tobytes()


def _poison(leaves):
    leaves[0].view(-1)[:5] = torch.tensor(
        [float("nan"), float("inf"), float("-inf"), float("nan"), 1e30])
    leaves[1].view(-1)[:3] = torch.tensor(
        [float("nan"), float("inf"), float("-inf")]).half()
    leaves[2].view(-1)[7] = float("nan")
    return leaves


@pytest.mark.parametrize("case", ["random", "zero_delta", "all_changed",
                                  "nan_inf"])
def test_device_pack_byte_equal_numpy(cuda, case):
    new = _leaves(1, cuda)
    base = {"random": _leaves(2, cuda), "zero_delta": [t.clone()
                                                       for t in new],
            "all_changed": [t + 1 if t.is_floating_point() else t.clone()
                            for t in new],
            "nan_inf": _poison(_leaves(3, cuda))}[case]
    if case == "nan_inf":
        new = _poison(new)
        new[0].view(-1)[100:110] = float("nan")
    before = [t.clone() for t in new]
    got = hotstate._pack_delta(new, base)
    host_new = [hotstate._host(t) for t in new]
    host_base = [hotstate._host(t) for t in base]
    with np.errstate(invalid="ignore", over="ignore"):
        want = hotstate._pack_delta_np(host_new, host_base)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    # The pack leaves its inputs as they were.
    assert all(_bytes(a) == _bytes(b) for a, b in zip(new, before))
    # The blob unpacks on the host onto the new leaves' bytes.
    back = hotstate._unpack_delta(got, host_base)
    assert hotstate._digest_state(back) == hotstate._digest_state(new)


def test_device_snapshot_and_restore_to_card(cuda):
    from torchmpi_tpu_torch import runtime

    new = _leaves(5, cuda)
    host = [hotstate._host(t) for t in new]
    assert np.array_equal(hotstate._pack_snap(new),
                          hotstate._pack_snap(host))
    assert hotstate._digest_state(new) == hotstate._digest_state(host)
    runtime.stop()
    runtime.init(device="cpu", hotstate="on")
    try:
        rep = hotstate.enable(2, rank=0, interval=3)
        states = [_leaves(s, cuda) for s in (5, 6, 7)]
        for i, st in enumerate(states, 1):
            rep.publish(st, i)
        got, step = rep.restore([torch.empty_like(t) for t in new])
        assert step == 3
        assert all(g.device == t.device and g.dtype == t.dtype
                   and _bytes(g) == _bytes(t)
                   for g, t in zip(got, states[-1]))
    finally:
        hotstate.disable()
        runtime.stop()
