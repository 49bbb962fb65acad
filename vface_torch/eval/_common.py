"""What the eval metrics share: building a net from its state dict, batched
feature extraction at full fp32."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vface_torch.utils.platform import resolve_device


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block (the
    features are fp32, as the JAX package's), the settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def eval_net(cls, params, device="cuda") -> torch.nn.Module:
    """``params`` as it is if it is a module, else ``cls()`` on ``device`` (CUDA
    unless asked for the CPU) loaded strictly from the state dict, in eval mode."""
    if isinstance(params, torch.nn.Module):
        return params.eval()
    dev = resolve_device(device)
    with torch.device(dev):
        net = cls()
    net.load_state_dict(params)
    return net.eval()


def net_device(net: torch.nn.Module) -> torch.device:
    return next(net.parameters()).device


def as_tensor(x, device) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def extract(fn, images, batch: int, net) -> np.ndarray:
    """``fn`` over ``images`` in batches on the net's device, at full fp32 -> numpy."""
    dev = net_device(net)
    out = []
    with torch.inference_mode(), full_fp32():
        for i in range(0, len(images), batch):
            out.append(fn(as_tensor(images[i:i + batch], dev)).cpu().numpy())
    return np.concatenate(out, axis=0)
