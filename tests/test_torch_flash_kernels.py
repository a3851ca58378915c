"""The port's CUDA flash-attention kernels against their plain versions.

Card-only: every test is marked ``gpu`` and skips without a CUDA card.  The
file imports nothing of JAX, so on a machine with a card and no JAX it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_flash_kernels.py -q

The CPU parity of the plain versions with the JAX package is
tests/test_torch_flash.py.
"""

import math

import pytest
import torch

from torchmpi_tpu_torch.ops import flash
from torchmpi_tpu_torch.parallel.sequence import reference_attention

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# f32 kernel vs f32 plain version: same math, another summation order.
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset)
CASES = [
    (1, 64, 64, 2, 2, 16, False, None, 0, 0),
    (2, 100, 100, 4, 2, 32, True, None, 0, 0),      # ragged edge, GQA
    (1, 130, 130, 4, 1, 64, True, 24, 0, 0),        # window, MQA
    (2, 96, 160, 8, 2, 128, True, 40, 64, 0),       # offsets, Tq != Tkv
    (1, 257, 257, 4, 4, 128, True, 1, 0, 0),        # window 1: diagonal
    (1, 33, 70, 2, 2, 64, True, None, 0, 20),       # rows with no key
    # flash_bwd_dkv's tiles: 64 keys a block, 32 q rows a step, mma tiles
    # of 16 keys x 8 rows or columns, k-steps of 8.  Lengths one short of
    # and one past each tile edge, a GQA group of 8 on one kv head, D 16
    # (one pair of k-steps), non-causal blocks (never masked but at the
    # ragged edge), and offsets, at every head dim.
    (1, 45, 77, 8, 1, 16, False, None, 0, 0),
    (1, 33, 65, 4, 2, 32, False, None, 0, 0),
    (2, 31, 63, 8, 1, 128, True, None, 40, 0),
    (2, 100, 130, 8, 1, 64, True, None, 30, 0),
    (1, 96, 96, 4, 4, 16, True, 17, 5, 5),
    (1, 64, 64, 2, 1, 128, True, 40, 0, 0),
    (1, 160, 200, 8, 1, 64, False, None, 0, 0),
    # flash_fwd's and flash_bwd_dq's tiles: 128 q rows a block, as 4 heads
    # x 32 rows (a group divisible by 4), 2 x 64 (by 2) or 1 x 128, 16 rows
    # a warp; kv blocks of 64 keys (forward) and 32 keys (dQ); mma tiles of
    # 8.  Lengths one short of and one past each tile edge, at every head
    # dim, with a GQA group of 8 and with offsets.
    (1, 127, 129, 8, 1, 16, True, None, 5, 0),
    (1, 129, 63, 8, 1, 32, True, 40, 64, 0),
    (1, 65, 127, 16, 2, 64, True, None, 60, 3),
    (2, 33, 65, 8, 1, 128, False, None, 0, 0),
    (1, 63, 33, 8, 1, 128, True, 24, 30, 0),
    (1, 17, 31, 8, 1, 16, True, None, 14, 0),
    (1, 129, 129, 2, 2, 64, True, None, 0, 0),
    (1, 127, 95, 4, 2, 32, True, 50, 0, 30),
    (2, 15, 97, 24, 3, 128, True, None, 90, 0),
    # Head dims the kernels are not built for: the wrappers zero-pad them
    # to the next kernel head dim (8 -> 16, 24 -> 32, 48 -> 64, 96 -> 128).
    (1, 64, 64, 2, 2, 8, False, None, 0, 0),
    (2, 100, 130, 4, 2, 8, True, 24, 30, 0),
    (1, 129, 129, 4, 1, 24, True, None, 0, 0),
    (1, 96, 160, 8, 2, 48, True, 40, 64, 0),
    (2, 127, 95, 4, 2, 96, True, 50, 0, 30),
]


def _close(got, want, what):
    tol = RTOL * max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_plain(cuda, case):
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, Tq, H, D, generator=g, device=cuda)
    k = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    v = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    do = torch.randn(B, Tq, H, D, generator=g, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=window,
              q_offset=qo, kv_offset=ko)
    before = dict(flash.LAUNCHES)
    o, lse = flash.flash_fwd(q, k, v, **kw)
    o2, lse2 = flash.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_ref, "o")
    _close(lse, lse_ref, "lse")
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "two fwd differ"
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dq2 = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    _close(dq, flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw), "dq")
    assert torch.equal(dq, dq2), "two dq calls differ"
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk2, dv2 = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    _close(dk, dk_ref, "dk")
    _close(dv, dv_ref, "dv")
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2), "two calls differ"
    torch.cuda.synchronize()
    twice = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
             "flash_fwd_residual": 0}
    assert all(flash.LAUNCHES[n] == before[n] + twice[n] for n in before)
    assert torch.isfinite(o).all() and torch.isfinite(dq).all()


def _bwd_inputs(dev, B, Tq, Tkv, H, Hkv, D, kw, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Tq, H, D, generator=g, device=dev)
    k = torch.randn(B, Tkv, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, Tkv, Hkv, D, generator=g, device=dev)
    do = torch.randn(B, Tq, H, D, generator=g, device=dev)
    o, lse = flash.flash_fwd_plain(q, k, v, **kw)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    return q, k, v, do, lse, dvec


def _shifted(t):
    """A contiguous copy of t that starts 4 bytes into its storage."""
    out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


# The residual launcher at every case above, and at the ring's three kinds
# of step at the sequence-parallel path's shard shapes: a kv shard behind
# the q shard (every key valid), the diagonal, and one ahead (every key
# masked).
RESIDUAL_CASES = CASES + [
    (1, 2048, 2048, 16, 16, 128, True, None, 2048, 0),
    (1, 2048, 2048, 16, 16, 128, True, None, 2048, 2048),
    (1, 2048, 2048, 16, 16, 128, True, None, 0, 2048),
]


@pytest.mark.parametrize("case", RESIDUAL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_residual_kernel_matches_plain(cuda, case):
    """``flash_fwd_residual`` (num, m, l) against its plain version within
    1e-4 of each one's largest, two calls bitwise, the fully masked rows
    exactly (NEG_INF, 0, 0), and num / l equal to the plain kernel's o."""
    B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, Tq, H, D, generator=g, device=cuda)
    k = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    v = torch.randn(B, Tkv, Hkv, D, generator=g, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=window,
              q_offset=qo, kv_offset=ko)
    before = dict(flash.LAUNCHES)
    got = flash.flash_fwd_residual(q, k, v, **kw)
    again = flash.flash_fwd_residual(q, k, v, **kw)
    want = flash.flash_fwd_residual_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_fwd_residual"] == \
        before["flash_fwd_residual"] + 2
    num, m, l = got
    live = want[2] > 0
    _close(num, want[0], "num")
    _close(torch.where(live, m, 0.0), torch.where(live, want[1], 0.0), "m")
    _close(l, want[2], "l")
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two differ"
    assert torch.equal(m[~live], torch.full_like(m[~live], flash.NEG_INF))
    assert (l[~live] == 0).all()
    assert (num.transpose(1, 2)[~live] == 0).all()
    o, _ = flash.flash_fwd(q, k, v, **kw)
    denom = torch.where(live, l, torch.ones_like(l)).transpose(1, 2)
    _close(num / denom[..., None], o, "num / l")


def test_bwd_dkv_rejects_unaligned_rows(cuda):
    """The dK/dV kernel copies rows in 16-byte pieces: a contiguous q that
    starts 4 bytes into its storage is refused, not read misaligned."""
    kw = dict(scale=0.25, causal=True)
    q, k, v, do, lse, dvec = _bwd_inputs(cuda, 1, 8, 8, 2, 2, 16, kw, 5)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_bwd_dkv(_shifted(q), k, v, do, lse, dvec, **kw)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_fwd_rejects_unaligned_rows(cuda, which):
    """The forward copies q, k and v rows in 16-byte pieces too."""
    kw = dict(scale=0.25, causal=True)
    qkv = dict(zip("qkv", _bwd_inputs(cuda, 1, 8, 8, 2, 2, 16, kw, 6)[:3]))
    qkv[which] = _shifted(qkv[which])
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_fwd(qkv["q"], qkv["k"], qkv["v"], **kw)


@pytest.mark.parametrize("which", ["q", "do"])
def test_bwd_dq_rejects_unaligned_rows(cuda, which):
    """The dQ kernel copies q, k, v and dO rows in 16-byte pieces."""
    kw = dict(scale=0.25, causal=True)
    args = dict(zip(("q", "k", "v", "do", "lse", "dvec"),
                    _bwd_inputs(cuda, 1, 8, 8, 2, 2, 16, kw, 7)))
    args[which] = _shifted(args[which])
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_bwd_dq(*args.values(), **kw)


def test_autograd_matches_dense_oracle(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 200, h, 64, generator=g, device=cuda) * 0.5
               for h in (8, 2, 2))
    w = torch.randn(2, 200, 8, 64, generator=g, device=cuda)
    grads = []
    for fn in (flash.flash_attention_grad, reference_attention):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*xs, causal=True, window=50) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b, what in zip(*grads, "qkv"):
        _close(a, b, f"d{what}")


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        flash.flash_fwd(q.half(), q.half(), q.half(), scale=1.0,
                        causal=True)
    with pytest.raises(ValueError):
        flash.flash_fwd(q.transpose(1, 2), q, q, scale=1.0, causal=True)
    # Past the largest kernel head dim: refused, by the kernel's name.
    qq = torch.randn(1, 8, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="flash_fwd: head_dim 160"):
        flash.flash_fwd(qq, qq, qq, scale=1.0, causal=True)
    lse = torch.zeros(1, 2, 8, device=cuda)
    for fn in (flash.flash_bwd_dq, flash.flash_bwd_dkv):
        with pytest.raises(ValueError, match=f"{fn.__name__}: head_dim 160"):
            fn(qq, qq, qq, qq, lse, lse, scale=1.0, causal=True)


def test_transformer_step_at_head_dim_8(cuda):
    """TransformerLM(head_dim=8, attn_impl="flash"), the JAX package's tiny
    bench shape: a forward and backward on the card through the padded
    kernels, against the dense-attention model on the same weights."""
    from torchmpi_tpu_torch.models import TransformerLM

    cfg = dict(vocab=128, embed=32, depth=2, num_heads=4, head_dim=8,
               num_kv_heads=2, max_len=64, window=24, pos_emb="rope")
    g = torch.Generator(device=cuda).manual_seed(4)
    tok = torch.randint(0, 128, (2, 64), generator=g, device=cuda)
    models = [TransformerLM(**cfg, attn_impl=impl, device=cuda, generator=g)
              for impl in ("flash", "local")]
    models[1].load_state_dict(models[0].state_dict())
    grads = []
    for impl, model in zip(("flash", "local"), models):
        before = dict(flash.LAUNCHES)
        logits = model(tok)
        logits.float().square().mean().backward()
        torch.cuda.synchronize()
        launched = any(flash.LAUNCHES[n] > before[n] for n in before)
        assert launched == (impl == "flash")
        assert torch.isfinite(logits).all()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, want in grads[1].items():
        _close(grads[0][name], want, name)
