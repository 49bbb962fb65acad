"""Shared helpers for the PyTorch port's parity tests (``tests/test_torch_*.py``).

Inputs are made with seeded numpy and handed to the JAX package and to the
port as arrays; the port runs on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import torch

# Under pytest-xdist each worker is one of PYTEST_XDIST_WORKER_COUNT processes
# on the host: torch gets its share of the cores. OpenMP threads that
# outnumber the cores spin against each other and slow every worker's torch
# work many times over (a tiny swap_video_frames call: seconds alone, minutes
# beside five other workers at the host's full thread count).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


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


def he_tree(tree):
    """A seeded tree with its conv and dense kernels scaled by sqrt(2) (He-normal
    scale): a deep ReLU net keeps activations of order 1 instead of halving
    their variance at every layer (an InceptionV3 on LeCun-normal kernels ends
    at ~1e-6, where a Frechet distance is all regulariser)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * np.float32(np.sqrt(2.0)) if getattr(path[-1], "key", "") == "kernel" else x, tree)


def smooth_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded smooth images (n, h, w, 3) in [0, 1]: low-frequency noise, upsampled."""
    base = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    return torch.sigmoid(up).permute(0, 2, 3, 1).numpy().copy()


def face_keep(n: int, s: int) -> np.ndarray:
    """Keep-masks (n, s, s, 1): 1 outside an ellipse where a face would sit."""
    yy, xx = np.mgrid[:s, :s]
    face = ((yy - s * 0.55) / (s * 0.3)) ** 2 + ((xx - s * 0.5) / (s * 0.24)) ** 2 <= 1.0
    return np.broadcast_to((~face).astype(np.float32)[None, :, :, None], (n, s, s, 1)).copy()


def tiny_video_bundle(n: int, seed: int, s: int = 32, hw=(48, 64)) -> dict:
    """Both sides of the tiny video path from one seeded set: the JAX bundle
    (``ModelConfig.tiny(image_size=s)``; its params from :func:`seeded_bundle_params`,
    so no JAX init is compiled) and aux nets (BiSeNet, RAFT with 2 iterations,
    the shipped landmark net), the port's model (conditioner included) and aux
    state dicts on the CPU, n seeded frames of ``hw``, a source and keep-masks.
    Seeds ``seed`` .. ``seed + 4``."""
    import jax.numpy as jnp

    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.models.raft import RAFT, RAFTConfig
    from vface_tpu.preprocess.landmarks import load_default_landmark_params
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import from_flax_aux, from_flax_params

    jm = JModel(JConfig.tiny(image_size=s))
    params = seeded_bundle_params(jm, seed=seed)
    x = jnp.zeros((1, s, s, 3))
    jaux = {"bisenet": seeded_flax_params(BiSeNet(), jnp.zeros((1, 64, 64, 3)), seed=seed + 1),
            "raft": seeded_flax_params(RAFT(RAFTConfig(iters=2)), x, x, seed=seed + 2),
            "landmark": load_default_landmark_params()}
    model = VFaceModel(ModelConfig.tiny(image_size=s), device="cpu", conditioner=True)
    model.load_params(from_flax_params(np_tree(params)))
    return dict(jm=jm, params=params, jaux=jaux, model=model, aux=from_flax_aux(np_tree(jaux)),
                frames=smooth_frames(n, *hw, seed=seed + 3), source=smooth_frames(1, *hw, seed=seed + 4)[0],
                keep=face_keep(n, s))


def jax_noise(seed: int = 0):
    """A sampler noise source that replays the JAX samplers' draws: at step
    ``idx`` the normal draw from the ``idx``-th ``sub`` of the chain ``key, sub =
    split(key)`` from ``PRNGKey(seed)``, as each JAX sampler call makes it."""
    import jax.numpy as jnp

    def noise(idx, shape):
        key = jax.random.PRNGKey(seed)
        for _ in range(idx + 1):
            key, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))

    return noise
