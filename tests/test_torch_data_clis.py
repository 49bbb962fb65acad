"""The port's data-preparation CLIs and ``driven_demo`` against the JAX package's scripts.

Each JAX script runs in this process (its ``main`` under a patched
``sys.argv``), the port's CLI through ``main(argv)`` with ``VFACE_PLATFORM=cpu``,
on the same inputs and the same weight npz files: ``generate_config``'s YAML
byte for byte; ``create_square_gt_for_fid``'s PNGs and both mask combiners'
index images equal (overlapping attributes included); ``driven_demo``'s AVI
within 1 uint8 level at ``--tiny``. The CLIs with the aux nets
(``estimate_masks bisenet``, ``crop_and_mask``) are in ``test_torch_mask_clis.py``.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from _torch_port import np_tree, seeded_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VFACE_PLATFORM", "cpu")


def _jax_main(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    mod.main()


def _port_main(name, argv):
    mod = importlib.import_module(f"vface_torch.scripts.{name}")
    assert mod.main([str(a) for a in argv]) == 0


def _png(path):
    with Image.open(path) as img:
        return np.asarray(img)


def _faces(d, n=3, size=96, seed=0):
    from vface_torch.preprocess.synthetic_faces import render_face

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = (np.clip(render_face(rng, size)[0], 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"face{i}.png"))
    return d


def test_generate_config_yaml_is_byte_equal(tmp_path, monkeypatch):
    vids, srcs = tmp_path / "videos", tmp_path / "sources"
    vids.mkdir()
    srcs.mkdir()
    for name in ("clip10.y4m", "clip2.y4m", "Clip1.y4m", "frames_3"):
        (vids / name).mkdir() if "." not in name else (vids / name).write_bytes(b"")
    for name in ("s10.png", "s2.JPG", "s1.jpeg", "notes.txt"):
        (srcs / name).write_bytes(b"")
    _jax_main("generate_config", ["--videos", vids, "--sources", srcs, "--out", tmp_path / "j.yaml"], monkeypatch)
    _port_main("generate_config", ["--videos", vids, "--sources", srcs, "--out", tmp_path / "t.yaml"])
    got, want = (tmp_path / "t.yaml").read_bytes(), (tmp_path / "j.yaml").read_bytes()
    assert got == want and got.count(b"- video:") == 3


def test_square_gt_pngs_are_equal(tmp_path, monkeypatch):
    src = tmp_path / "in"
    src.mkdir()
    r = np.random.default_rng(1)
    for name, (h, w) in (("a.png", (40, 64)), ("b.jpg", (70, 50)), ("c.PNG", (33, 33))):
        Image.fromarray(r.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(src / name)
    _jax_main("create_square_gt_for_fid", ["--indir", src, "--outdir", tmp_path / "j", "--size", 24], monkeypatch)
    _port_main("create_square_gt_for_fid", ["--indir", src, "--outdir", tmp_path / "t", "--size", 24])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == ["a.png", "b.png", "c.png"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def _attribute_masks(root, attrs, ids, size=32, seed=2):
    """Overlapping random disks for each id's attributes (some missing)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for i in ids:
        d = os.path.join(root, str(i // 2000))
        os.makedirs(d, exist_ok=True)
        for a in attrs:
            if r.uniform() < 0.25:
                continue
            cy, cx, rad = r.uniform(0, size, 2).tolist() + [r.uniform(4, 14)]
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= rad**2).astype(np.uint8) * 255
            m[r.uniform(size=m.shape) < 0.05] = 200  # grey pixels: the two combiners threshold differently
            Image.fromarray(m).save(os.path.join(d, f"{i:05d}_{a}.png"))


def test_celeba_mask_combiners_are_equal(tmp_path, monkeypatch):
    from vface_torch.scripts.estimate_masks import CELEBA_ATTRS
    from vface_torch.scripts.process_celeba_masks import CELEBAHQ_LABEL_LIST

    root = tmp_path / "anno"
    _attribute_masks(root, CELEBAHQ_LABEL_LIST, range(3), size=512)
    argv = ["--mask_root", root, "--n", 3]
    _jax_main("process_celeba_masks", argv + ["--out", tmp_path / "j"], monkeypatch)
    _port_main("process_celeba_masks", argv + ["--out", tmp_path / "t"])
    for i in range(3):
        got, want = _png(tmp_path / "t" / f"{i}.png"), _png(tmp_path / "j" / f"{i}.png")
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 3  # several attributes, overwritten in order where they overlap
    root2 = tmp_path / "anno2"
    _attribute_masks(root2, CELEBA_ATTRS, [0, 1, 2003], seed=3)
    argv = ["celeba", "--anno_dir", root2, "--count", 2004]
    _jax_main("estimate_masks", argv + ["--outdir", tmp_path / "j2"], monkeypatch)
    _port_main("estimate_masks", argv + ["--outdir", tmp_path / "t2"])
    assert sorted(os.listdir(tmp_path / "t2")) == sorted(os.listdir(tmp_path / "j2")) == ["0.png", "1.png", "2003.png"]
    for n in os.listdir(tmp_path / "j2"):
        np.testing.assert_array_equal(_png(tmp_path / "t2" / n), _png(tmp_path / "j2" / n))


def test_driven_demo_avi_is_within_a_level(tmp_path, monkeypatch):
    """Driving frames as a Y4M (48 x 40, resized to the tiny 32^2) and as a PNG
    folder; the generator's weights from one npz of a seeded tree."""
    from vface_tpu.models.face_vid2vid import FV2VConfig, OcclusionAwareGenerator
    from vface_tpu.runtime.checkpoint import save_params_npz
    from vface_torch.io.video import write_y4m

    s = FV2VConfig.tiny().image_size
    params = np_tree(seeded_flax_params(OcclusionAwareGenerator(FV2VConfig.tiny()), jnp.zeros((1, s, s, 3)),
                                        jnp.zeros((1, s, s, 3)), seed=41))
    save_params_npz(str(tmp_path / "fv2v.npz"), params)
    r = np.random.default_rng(5)
    frames = r.integers(0, 256, size=(3, 48, 40, 3), dtype=np.uint8)
    write_y4m(str(tmp_path / "drive.y4m"), frames, fps=10)
    (tmp_path / "drive").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "drive" / f"{i:03d}.png")
    Image.fromarray(r.integers(0, 256, size=(50, 60, 3), dtype=np.uint8)).save(tmp_path / "src.png")
    for drive in ("drive.y4m", "drive"):
        argv = ["--source", tmp_path / "src.png", "--driving", tmp_path / drive, "--params", tmp_path / "fv2v.npz",
                "--tiny", "--fps", 7]
        _jax_main("driven_demo", argv + ["--out", tmp_path / "j.avi"], monkeypatch)
        _port_main("driven_demo", argv + ["--out", tmp_path / "t.avi"])
        got = np.frombuffer((tmp_path / "t.avi").read_bytes(), np.uint8)
        want = np.frombuffer((tmp_path / "j.avi").read_bytes(), np.uint8)
        assert got.shape == want.shape and got[:4].tobytes() == b"RIFF"
        assert got.tobytes().count(b"00db") == want.tobytes().count(b"00db") >= 3
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
