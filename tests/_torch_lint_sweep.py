"""Default lint sweep for ``torchmpi_tpu_torch/analysis/tool.py``: the
shipped decode / serving entry points, declared as ``LINT_TARGETS`` so
that the tool runs the whole rule pack, the S1 / S2 cache-write rules
included, on every invocation with no arguments; the counterparts of the
JAX package's ``tests/fixtures_lint_sweep.py``, one target for each of
its seven.  The tool must exit 0 on this file: a change that brings
back an unclamped cache write turns the default sweep red.

Not a pytest module.  The model is small and random (seeded);
the cache-write rules read the aten graph of each tick under fake
tensors (``make_fx``), so nothing there computes.  The tool starts the
runtime (on its ``--device``) before it loads this file, which makes its
tensors on ``runtime.device()``.
"""

import importlib

import torch

import torchmpi_tpu_torch as mpi

_DEV = mpi.runtime.device()

_gen = importlib.import_module("torchmpi_tpu_torch.models.generate")
tpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")

# -- dense single-device model (the serving engine's shapes) --------------

_SLOTS = 2          # pool rows
_SLOT_TOKENS = 16   # per-slot cache depth
_K = 2              # draft length of the verify forward

_model = mpi.models.TransformerLM(
    vocab=50, embed=32, depth=2, num_heads=4, head_dim=8, max_len=64,
    pos_emb="rope", device=_DEV,
    generator=torch.Generator(_DEV).manual_seed(0))
_model.eval()


def _pool():
    return _model.init_cache(_SLOTS, _SLOT_TOKENS)


def _sweep_generate(prompt):
    return _gen.generate(_model, prompt, 4)


def _sweep_prefill(prompt):
    return _gen.slot_prefill(_model, prompt, max_len=_SLOT_TOKENS,
                             true_len=6)[1]


def _sweep_decode(ks, vs, tokens, positions):
    cache = mpi.models.transformer.KVCache(ks, vs)
    return _gen.slot_decode_step(_model, cache, tokens, positions)[1]


def _sweep_verify(ks, vs, tokens, positions):
    cache = mpi.models.transformer.KVCache(ks, vs)
    return _gen.slot_verify_step(_model, cache, tokens, positions)[1]


def _sweep_write(pool_ks, pool_vs, one_ks, one_vs):
    pool = mpi.models.transformer.KVCache(pool_ks, pool_vs)
    one = mpi.models.transformer.KVCache(one_ks, one_vs)
    _gen.slot_write(pool, one, 1)
    return pool.k


# -- the mesh-parallel decode blocks (the TP replica's shapes) ------------

_TP = 2
_TP_PARAMS = tpg.init_tp_lm(torch.Generator(_DEV).manual_seed(1), vocab=50,
                            embed=32, depth=1, num_heads=4, device=_DEV)
_stack = []


def _tp_stack():
    """The rank-major stack of 2 "tp" ranks, made at the first call
    (under the communicator the check pushes)."""
    if not _stack:
        _stack.append(tpg._rank_major(_TP_PARAMS, _TP, "tp", 4, None, None))
    return _stack[0]


def _sweep_tp_decode(x, ck, cv, pos):
    st = _tp_stack()
    return tpg._block_decode(st.form, x, st.p["blocks"][0], ck, cv,
                             pos.expand(x.shape[1]), 4)


def _sweep_tp_decode_rows(x, ck, cv, pos_rows):
    st = _tp_stack()
    return tpg._block_decode(st.form, x, st.p["blocks"][0], ck, cv,
                             pos_rows, 4)


_i64 = torch.long
_pool_cache = _pool()
_one_cache = _model.init_cache(1, _SLOT_TOKENS)
_TP_CACHE = torch.zeros(_TP, 1, _SLOT_TOKENS, 2, 8, device=_DEV)
_TP_CACHE_ROWS = torch.zeros(_TP, _SLOTS, _SLOT_TOKENS, 2, 8,
                             device=_DEV)

LINT_TARGETS = [
    dict(fn=_sweep_generate,
         args=(torch.zeros(1, 5, dtype=_i64, device=_DEV),),
         label="sweep_generate"),
    dict(fn=_sweep_prefill,
         args=(torch.zeros(1, 8, dtype=_i64, device=_DEV),),
         label="sweep_slot_prefill"),
    dict(fn=_sweep_decode,
         args=(_pool_cache.k, _pool_cache.v,
               torch.zeros(_SLOTS, dtype=_i64, device=_DEV),
               torch.zeros(_SLOTS, dtype=_i64, device=_DEV)),
         label="sweep_slot_decode"),
    dict(fn=_sweep_verify,
         args=(_pool_cache.k, _pool_cache.v,
               torch.zeros(_SLOTS, _K + 1, dtype=_i64, device=_DEV),
               torch.zeros(_SLOTS, dtype=_i64, device=_DEV)),
         label="sweep_slot_verify"),
    dict(fn=_sweep_write,
         args=(_pool_cache.k, _pool_cache.v, _one_cache.k, _one_cache.v),
         label="sweep_slot_write"),
    dict(fn=_sweep_tp_decode,
         args=(torch.zeros(_TP, 1, 1, 32, device=_DEV), _TP_CACHE,
               _TP_CACHE.clone(),
               torch.zeros(1, dtype=_i64, device=_DEV)),
         comm={"tp": _TP}, label="sweep_tp_block_decode"),
    dict(fn=_sweep_tp_decode_rows,
         args=(torch.zeros(_TP, _SLOTS, 1, 32, device=_DEV), _TP_CACHE_ROWS,
               _TP_CACHE_ROWS.clone(),
               torch.zeros(_SLOTS, dtype=_i64, device=_DEV)),
         comm={"tp": _TP}, label="sweep_tp_block_decode_rows"),
]
