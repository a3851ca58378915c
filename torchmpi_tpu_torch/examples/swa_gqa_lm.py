"""The modern-LM stack: RoPE, a sliding window and grouped-query
attention, decoded through the GQA cache.

The counterpart of the JAX package's ``examples/swa_gqa_lm.py``: trains a
Mistral-shaped small LM (embed 64, depth 2, 4 heads of 16, 2 kv heads,
``pos_emb="rope"`` with no position table, window 8; ``--attn flash``
trains on the flash kernels) on the rule ``t_{i+1} = (3 t_i + 1) mod V``,
then decodes held-out prompts through the cache, which keeps only the kv
heads and bands its mask with the window the model trained with.  JAX's
assertion: the continuations follow the rule on more than 80% of tokens.

Run: ``python -m torchmpi_tpu_torch.examples.swa_gqa_lm [--attn flash]``
(``--device cpu`` on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.examples.lm_generate import rule_accuracy, \
    rule_batch, train
from torchmpi_tpu_torch.models import TransformerLM, generate


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 250, "batch_size": 32, "lr": 3e-3},
        seq_len=dict(type=int, default=32),
        vocab=dict(type=int, default=32),
        window=dict(type=int, default=8),
        kv_heads=dict(type=int, default=2),
        gen_steps=dict(type=int, default=8),
        attn=dict(type=str, default="local", choices=["local", "flash"]))
    with common.runtime(args) as dev:
        V, T = args.vocab, args.seq_len
        model = TransformerLM(vocab=V, embed=64, depth=2, num_heads=4,
                              head_dim=16, max_len=T, pos_emb="rope",
                              window=args.window,
                              num_kv_heads=args.kv_heads,
                              attn_impl=args.attn, device=dev,
                              generator=torch.Generator(dev).manual_seed(
                                  args.seed))
        assert not hasattr(model, "pos_embed"), \
            "rope model must have no pos table"
        losses = train(model, args, dev, T, V)
        prompts = rule_batch(np.random.RandomState(args.seed + 999), 8,
                             T, V)[:, :4]
        out = generate(model, prompts, args.gen_steps).cpu().numpy()
        acc = rule_accuracy(out, prompts, V)
        print(f"decode: {out.shape[0]} prompts x {args.gen_steps} tokens, "
              f"rule accuracy {acc:.3f} (window {args.window}, kv heads "
              f"{args.kv_heads}, rope)")
    assert acc > 0.8, "decoded continuations do not follow the learned rule"
    return {"losses": losses, "greedy": acc}


if __name__ == "__main__":
    main()
