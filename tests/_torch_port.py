"""Shared helpers for the PyTorch port's parity tests (``tests/test_torch_*.py``).

Inputs are made with seeded numpy and handed to the JAX package and to the
port as arrays; the port runs on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import jax
import numpy as np
import torch


def np_tree(tree):
    """A JAX param tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(jax_params, image_size: int = 32):
    """The port's tiny VFaceModel on the CPU, loaded from the JAX bundle's params."""
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import from_flax_params

    model = VFaceModel(ModelConfig.tiny(image_size=image_size), device="cpu")
    model.load_params(from_flax_params(np_tree({"unet": jax_params["unet"], "vae": jax_params["vae"]})))
    return model


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, atol: float, rtol: float = 0.0) -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)
