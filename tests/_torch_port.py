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


def seeded_flax_params(module, *inputs, seed: int = 0):
    """A Flax module's param tree (its structure from ``jax.eval_shape``, so
    nothing is compiled) filled by :func:`seeded_tree`."""
    shapes = jax.eval_shape(lambda r: module.init(r, *inputs)["params"], jax.random.PRNGKey(0))
    return seeded_tree(shapes, seed)


def seeded_bundle_params(model, seed: int = 0):
    """A JAX ``VFaceModel``'s ``{"unet", "vae", "cond"}`` params, the structure
    from ``jax.eval_shape`` of its init (nothing is compiled), filled by
    :func:`seeded_tree`: no convolution is zero, as the init's are."""
    return seeded_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0)), seed)


def seeded_tree(shapes, seed: int = 0):
    """A tree of shapes filled with seeded numpy: conv kernels LeCun-normal,
    biases N(0, 0.05^2), norm scales 1 + N(0, 0.05^2), frozen-BN means
    N(0, 0.05^2) and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        noise = (0.05 * rng.normal(size=s.shape)).astype(np.float32)
        return noise + 1.0 if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, shapes)
