"""Train a small LM, then decode it over the KV cache: the serving path.

The counterpart of the JAX package's ``examples/lm_generate.py``: trains a
``TransformerLM`` (embed 64, depth 2, 4 heads of 8) on the learnable
next-token task ``t_{i+1} = (3 t_i + 1) mod V`` with Adam, then continues
held-out prompts with ``models.generate`` (greedy, and Gumbel-max sampling
at temperature 0.7 within top-k 4 / top-p 0.95), with ``beam_search``
(4 beams, length penalty 0.6) and with ``eos_id`` stopping.  JAX's
assertions: greedy and beam continuations follow the rule on more than
80% of tokens, sampled ones on more than 50%, and the row that hits eos
flatlines on it.

Run: ``python -m torchmpi_tpu_torch.examples.lm_generate`` (``--device
cpu`` on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.models import TransformerLM, beam_search, generate


def rule_batch(rng: np.random.RandomState, batch: int, T: int, V: int):
    """[batch, T] sequences of the rule from random first tokens (JAX's
    ``make_batch``)."""
    toks = [rng.randint(0, V, size=(batch, 1))]
    for _ in range(T - 1):
        toks.append((toks[-1] * 3 + 1) % V)
    return np.concatenate(toks, axis=1).astype(np.int64)


def rule_accuracy(out: np.ndarray, prompts: np.ndarray, V: int) -> float:
    """Share of generated tokens that follow the rule from each prompt's
    last token."""
    Tp = prompts.shape[1]
    correct = total = 0
    for b in range(out.shape[0]):
        t = int(prompts[b, -1])
        for j in range(Tp, out.shape[1]):
            t = (t * 3 + 1) % V
            correct += int(out[b, j] == t)
            total += 1
    return correct / total


def train(model: TransformerLM, args, dev, T: int, V: int) -> list:
    """Adam on the rule's next-token loss; returns the losses."""
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    rng = np.random.RandomState(args.seed)
    losses = []
    for i in range(args.steps):
        tok = torch.from_numpy(rule_batch(rng, args.batch_size, T, V)).to(dev)
        logits = model(tok)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                               tok[:, 1:].reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
        if i % 50 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    print(f"final train loss {losses[-1]:.4f}")
    return losses


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"steps": 250, "batch_size": 32, "lr": 3e-3},
        seq_len=dict(type=int, default=16),
        vocab=dict(type=int, default=32),
        gen_steps=dict(type=int, default=8))
    with common.runtime(args) as dev:
        V, T = args.vocab, args.seq_len
        model = TransformerLM(vocab=V, embed=64, depth=2, num_heads=4,
                              head_dim=8, max_len=T, device=dev,
                              generator=torch.Generator(dev).manual_seed(
                                  args.seed))
        losses = train(model, args, dev, T, V)
        model.eval()
        prompts = rule_batch(np.random.RandomState(args.seed + 999), 8,
                             T, V)[:, :4]
        n = args.gen_steps
        out = generate(model, prompts, n).cpu().numpy()
        acc = rule_accuracy(out, prompts, V)
        print(f"greedy decode: {out.shape[0]} prompts x {n} tokens, rule "
              f"accuracy {acc:.3f}")
        print(f"sample: prompt {prompts[0].tolist()} -> "
              f"{out[0, 4:].tolist()}")
        acc_s = rule_accuracy(generate(
            model, prompts, n, temperature=0.7, top_k=4, top_p=0.95,
            seed=7).cpu().numpy(), prompts, V)
        acc_b = rule_accuracy(beam_search(
            model, prompts, n, beams=4, length_penalty=0.6).cpu().numpy(),
            prompts, V)
        print(f"top-k/top-p sampled accuracy {acc_s:.3f}, beam-4 accuracy "
              f"{acc_b:.3f}")
        # EOS: the rule successor of row 0's last prompt token; row 0 must
        # emit it at once and pad with it.
        eos = int((3 * prompts[0, -1] + 1) % V)
        stopped = generate(model, prompts, n, eos_id=eos)[0, 4:].tolist()
        print(f"eos={eos} stopping: row 0 -> {stopped}")
    assert all(t == eos for t in stopped), "row hitting eos must flatline"
    assert acc > 0.8, "greedy continuations do not follow the rule"
    assert acc_b > 0.8, "beam continuations do not follow the rule"
    assert acc_s > 0.5, "sampled continuations ignore the rule"
    return {"losses": losses, "greedy": acc, "sampled": acc_s,
            "beam": acc_b}


if __name__ == "__main__":
    main()
