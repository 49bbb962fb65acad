"""The port's ``estimate_masks bisenet`` and ``crop_and_mask`` CLIs against the JAX package's scripts.

As in ``test_torch_data_clis.py``: each JAX script in this process, the port's
CLI through ``main(argv)`` with ``VFACE_PLATFORM=cpu``, on the same
``render_face`` faces and the same npz files (the shipped landmark weights, a
seeded BiSeNet): masks equal, and ``crop_and_mask``'s crops at ``--size 64``
within 1 uint8 level.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import np_tree, seeded_flax_params
from test_torch_data_clis import _cpu, _faces, _jax_main, _png, _port_main  # noqa: F401  (_cpu: the autouse fixture)


@pytest.fixture(scope="module")
def aux_npz(tmp_path_factory):
    """``landmark`` (the shipped weights) and a seeded ``bisenet``, written by
    JAX's ``save_params_npz``; and the BiSeNet tree alone."""
    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.preprocess.landmarks import load_default_landmark_params
    from vface_tpu.runtime.checkpoint import save_params_npz

    d = tmp_path_factory.mktemp("aux")
    bisenet = np_tree(seeded_flax_params(BiSeNet(), jnp.zeros((1, 64, 64, 3)), seed=31))
    save_params_npz(str(d / "aux.npz"), {"landmark": np_tree(load_default_landmark_params()), "bisenet": bisenet})
    save_params_npz(str(d / "bisenet.npz"), bisenet)
    return d


def test_estimate_masks_bisenet_is_equal(tmp_path, monkeypatch, aux_npz):
    faces = _faces(tmp_path / "faces", n=3, size=64)
    argv = ["bisenet", "--indir", faces, "--params", aux_npz / "bisenet.npz", "--batch", 2]
    _jax_main("estimate_masks", argv + ["--outdir", tmp_path / "j"], monkeypatch)
    _port_main("estimate_masks", argv + ["--outdir", tmp_path / "t"])
    for n in sorted(os.listdir(tmp_path / "j")):
        got, want = _png(tmp_path / "t" / n), _png(tmp_path / "j" / n)
        assert got.shape == (512, 512)
        np.testing.assert_array_equal(got, want)


def test_crop_and_mask_is_within_a_level(tmp_path, monkeypatch, aux_npz):
    faces = _faces(tmp_path / "faces", n=3, size=128, seed=4)
    argv = ["--indir", faces, "--size", 64, "--aux_params", aux_npz / "aux.npz", "--batch", 2]
    _jax_main("crop_and_mask", argv + ["--outdir", tmp_path / "j"], monkeypatch)
    _port_main("crop_and_mask", argv + ["--outdir", tmp_path / "t"])
    names = sorted(os.listdir(tmp_path / "j" / "crops"))
    assert names == sorted(os.listdir(tmp_path / "t" / "crops")) and len(names) == 3
    for n in names:
        c_t, c_j = _png(tmp_path / "t" / "crops" / n), _png(tmp_path / "j" / "crops" / n)
        assert c_t.shape == (64, 64, 3)
        assert np.abs(c_t.astype(int) - c_j.astype(int)).max() <= 1
        np.testing.assert_array_equal(_png(tmp_path / "t" / "masks" / n), _png(tmp_path / "j" / "masks" / n))
