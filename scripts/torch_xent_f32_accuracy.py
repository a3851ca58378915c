#!/usr/bin/env python3
"""How close the fused loss's float32 routes come to float64 on the card,
at logits of ordinary size and in the hundreds.

    python3 scripts/torch_xent_f32_accuracy.py

needs one CUDA card and nvcc.  For each input (tests/test_torch_xent_kernels.py
``test_extreme_logits``' shape and scale, the same at scale 1, and at
depth 2048), it runs the forward and the dx kernel on float32 x and w on
each float32 route (``wgmma_tf32`` and ``tf32x3``, the route forced) and
the plain float32 versions, and reports against a float64 evaluation of
the same function: the largest |lse - lse64|, dx end to end (the route's
dx from its own lse) and dx at the float64 lse (the dx kernel alone, whose
z then meets an lse formed from other z), each relative to the largest
|reference|.  Prints one JSON line per input with the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (N, E, V, x scale, seed): the card test's extreme logits, the same at
# scale 1, and the extreme case at the flagship's depth.
CASES = ((200, 64, 640, 60.0, 4), (200, 64, 640, 1.0, 4),
         (200, 2048, 640, 60.0, 5))


def reference64(torch, x, w, lab, dl):
    """lse and dx of the function in float64 (labels outside [0, V) never
    match)."""
    z = x.double() @ w.double()
    lse = torch.logsumexp(z, dim=1)
    p = torch.exp(z - lse[:, None])
    cols = torch.arange(z.shape[1], device=z.device)
    p -= (lab.long()[:, None] == cols[None, :]).double()
    return lse, (p * dl.double()[:, None]) @ w.double().t()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torchmpi_tpu_torch.ops import xent

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    for N, E, V, scale, seed in CASES:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(N, E, generator=g, device=dev) * scale
        w = torch.randn(E, V, generator=g, device=dev) / E ** 0.5
        lab = torch.randint(0, V, (N,), generator=g, device=dev)
        dl = torch.randn(N, generator=g, device=dev)
        lse64, dx64 = reference64(torch, x, w, lab, dl)
        out = {"card": card, "shape": dict(N=N, E=E, V=V, x_scale=scale),
               "max_abs_lse": float(lse64.abs().max())}
        _, s = xent.xent_fwd_plain(x, w, lab)
        out["plain"] = {
            "lse_abs_err": float((s.double() - lse64).abs().max()),
            "dx_end_to_end": rel(xent.xent_bwd_dx_plain(x, w, lab, s, dl),
                                 dx64)}
        real = xent._route
        for route in ("wgmma_tf32", "tf32x3"):
            xent._route = lambda *a, dtype, r=route: r
            try:
                _, s = xent.xent_fwd(x, w, lab)
                dx = xent.xent_bwd_dx(x, w, lab, s, dl)
                dx_at64 = xent.xent_bwd_dx(x, w, lab, lse64.float(), dl)
            finally:
                xent._route = real
            out[route] = {"lse_abs_err": float((s.double() - lse64).abs().max()),
                          "dx_end_to_end": rel(dx, dx64),
                          "dx_at_lse64": rel(dx_at64, dx64)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
