"""8-bit-AdamW quality A/B (counterpart of
``this_and_that_vdm_tpu/cli/adam8bit_ab.py``).

Trains the same regression problem twice from the same initial weights,
data and learning rate: fp32 AdamW (``training/optimizers.adamw``) against
block-quantised 8-bit AdamW (``adamw8bit``, whose update is one K4 launch a
step on the card), and reports both loss curves:

    python -m this_and_that_vdm_tpu_torch.cli.adam8bit_ab --steps 300 [--device cpu]

The model is a 2-layer tanh MLP (width 256: every moment tensor spans many
256-element quantisation blocks).  Its parameters keep the JAX layout
(``x @ w1``, ``w1`` of shape ``[d_in, width]``), so the blocks cover the
same elements in both packages.  ``run_ab`` takes the initial parameters and
the data as arguments (numpy arrays), so a test can hand it the JAX run's.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

D_IN, D_OUT, N = 32, 8, 512


def make_problem(width: int = 256, seed: int = 0):
    """(initial parameters, (x, y)) as numpy arrays, from ``seed`` (made in
    float64, used in fp32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D_IN)
    w_true = rng.randn(D_IN, D_OUT) / np.sqrt(D_IN)
    y = np.tanh(x @ w_true) + 0.01 * rng.randn(N, D_OUT)
    init = {"w1": rng.randn(D_IN, width) / np.sqrt(D_IN), "b1": np.zeros((width,)),
            "w2": rng.randn(width, D_OUT) / np.sqrt(width), "b2": np.zeros((D_OUT,))}
    return init, (x, y)


def run_ab(steps: int = 300, width: int = 256, lr: float = 1e-3, seed: int = 0,
           init: Optional[dict] = None, data=None, device="cuda") -> dict:
    """``{"fp32": [(step, loss)], "adamw8bit": [...]}``: the loss before the
    update of every tenth step and of the last; ``init`` / ``data`` default
    to ``make_problem(width, seed)``."""
    from ..training import optimizers

    if init is None or data is None:
        made_init, made_data = make_problem(width, seed)
        init, data = init or made_init, data or made_data
    x, y = (torch.tensor(np.asarray(a, np.float32), device=device) for a in data)

    def loss_fn(p):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)

    def train(tx):
        params = {k: torch.tensor(np.asarray(v, np.float32), device=device,
                                  requires_grad=True)
                  for k, v in init.items()}
        state = tx.init({k: p.detach() for k, p in params.items()})
        losses = []
        for i in range(steps):
            loss = loss_fn(params)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            updates, state = tx.update(grads, state, {k: p.detach() for k, p in params.items()})
            optimizers.apply_updates(params, updates)
            if i % 10 == 0 or i == steps - 1:
                losses.append((i, float(loss.detach())))
        return losses

    constant = lambda count: np.float32(lr)  # noqa: E731
    return {"fp32": train(optimizers.adamw(constant)),
            "adamw8bit": train(optimizers.adamw8bit(constant))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("adam8bit_ab: no CUDA device; pass --device cpu to run on the CPU")
    curves = run_ab(args.steps, args.width, args.lr, args.seed, device=args.device)
    final_fp32, final_q8 = curves["fp32"][-1][1], curves["adamw8bit"][-1][1]
    print(json.dumps({
        "steps": args.steps, "device": args.device,
        "final_loss_fp32": final_fp32, "final_loss_adamw8bit": final_q8,
        "ratio": final_q8 / final_fp32,
        "curve_fp32": curves["fp32"], "curve_adamw8bit": curves["adamw8bit"],
    }))
    return curves


if __name__ == "__main__":
    main()
