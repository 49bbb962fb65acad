"""What the kernel wrappers share about autograd."""

from __future__ import annotations

import torch


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on ``ts``: grad mode is on (not
    ``no_grad`` or ``inference_mode``) and some input requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)
