"""Adam with bf16 first moments — the port of ``optax.adam(...,
mu_dtype=jnp.bfloat16)`` (``ir2rgb_tpu/train/model.py:665-668``,
``--train.adam_mu_dtype bf16``).

optax computes the new first moment in fp32 from the stored bf16 one and
the fp32 gradient, ``(1 - b1)·g + b1·mu`` (``b1·mu`` rounded to bf16, as
a Python float times a bf16 array is in JAX), takes its update from that
fp32 value, and only then stores it cast to bf16. ``torch.optim.Adam``
with a bf16 ``exp_avg`` would update from the rounded value. The second
moment and the parameters stay fp32. The update is optax's:
``p - lr · m̂ / (sqrt(v̂) + eps)`` with both moments bias-corrected.

Its state is ``torch.optim.Optimizer``'s (``exp_avg``, ``exp_avg_sq``,
``step`` per parameter), so ``state.clear()`` is the fresh optimizer of
the coarse-to-fine unfreeze, and ``state_dict`` / ``load_state_dict``
round-trip it (the loaded first moments stay bf16).
"""

from __future__ import annotations

import torch


class AdamBf16Mu(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 2e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    def load_state_dict(self, state_dict) -> None:
        # the base class casts every floating state tensor to its
        # parameter's dtype: put the first moments back in bf16
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamBf16Mu.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p,
                                                        dtype=torch.float32)
                st["step"] += 1
                t = st["step"]
                mu = (1 - b1) * g + b1 * st["exp_avg"]  # fp32
                nu = st["exp_avg_sq"].mul_(b2).add_((1 - b2) * (g * g))
                mu_hat = mu / (1 - b1 ** t)
                nu_hat = nu / (1 - b2 ** t)
                update = mu_hat / (nu_hat.sqrt() + group["eps"])
                p.add_(update.to(p.dtype), alpha=-group["lr"])
                st["exp_avg"] = mu.to(torch.bfloat16)
        return None
