"""The port's video IO, progress manifest and npz loader against the JAX package's.

``vface_torch.io.video`` and ``vface_tpu.io.video`` bind the same C++ source
(``native/vface_io.cc``), each built by its own package; the Y4M and AVI
bytes they write must be equal, and so must the frames they read. The plain
Python Y4M codec is held to JAX's bit for bit, and the native codec to it
(the reader exactly; the writer's chroma, which the two average in another
order, within one level). Nothing here compiles a JAX program.
"""

import collections
import fractions
import json
import wave

import jax
import numpy as np
import pytest

import vface_tpu.io.video as JV
from _torch_port import seeded_bundle_params, seeded_flax_params
from vface_torch.io import video as TV
from vface_torch.runtime.checkpoint import VideoProgressManifest, load_params_npz
from vface_torch.utils.convert import from_flax_aux, from_flax_params
from vface_tpu.runtime.checkpoint import VideoProgressManifest as JManifest
from vface_tpu.runtime.checkpoint import save_params_npz


def _frames(n=5, h=24, w=40, seed=0):
    """Seeded frames: a smooth gradient with noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 255 / (h + w)], -1)
    return np.clip(base[None] + rng.normal(0, 30, (n, h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_native():
    assert JV.native_available(), "the JAX package's native IO library did not build"
    return JV


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_native_y4m_matches_jax(tmp_path, jax_native):
    """The writer's bytes and the reader's frames and fps equal JAX's."""
    frames = _frames()
    TV.write_y4m(str(tmp_path / "t.y4m"), frames, fps=12)
    JV.write_y4m(str(tmp_path / "j.y4m"), frames, fps=12)
    assert _bytes(tmp_path / "t.y4m") == _bytes(tmp_path / "j.y4m")
    got, fps = TV.read_y4m(str(tmp_path / "j.y4m"))
    want, jfps = JV.read_y4m(str(tmp_path / "j.y4m"))
    assert fps == jfps == 12
    np.testing.assert_array_equal(got, want)


def test_plain_y4m_codec_matches_jax(tmp_path):
    """``plain=True`` is JAX's pure-Python codec bit for bit, both ways."""
    frames = _frames(seed=1)
    TV.write_y4m(str(tmp_path / "t.y4m"), frames, fps=10, plain=True)
    JV._write_y4m_py(str(tmp_path / "j.y4m"), frames, 10)
    assert _bytes(tmp_path / "t.y4m") == _bytes(tmp_path / "j.y4m")
    got, fps = TV.read_y4m(str(tmp_path / "j.y4m"), plain=True)
    want, jfps = JV._read_y4m_py(str(tmp_path / "j.y4m"))
    assert fps == jfps
    np.testing.assert_array_equal(got, want)


def test_native_y4m_codec_matches_the_plain_one(tmp_path):
    """The native reader equals the plain one on the same file; the native
    writer's luma equals the plain writer's and its chroma (the mean of the
    2x2 block's RGB, converted, against the mean of the converted values)
    is within one level."""
    frames = _frames(seed=2)
    TV.write_y4m(str(tmp_path / "n.y4m"), frames, fps=10)
    TV.write_y4m(str(tmp_path / "p.y4m"), frames, fps=10, plain=True)
    for name in ("n.y4m", "p.y4m"):
        np.testing.assert_array_equal(TV.read_y4m(str(tmp_path / name))[0],
                                      TV.read_y4m(str(tmp_path / name), plain=True)[0])
    n, p = _bytes(tmp_path / "n.y4m"), _bytes(tmp_path / "p.y4m")
    assert len(n) == len(p)
    head = n.index(b"\n") + 1
    assert n[:head] == p[:head]
    plane = 24 * 40
    per = len(b"FRAME\n") + plane * 3 // 2
    for i in range(frames.shape[0]):
        a = np.frombuffer(n, np.uint8, per, head + i * per).astype(int)
        b = np.frombuffer(p, np.uint8, per, head + i * per).astype(int)
        np.testing.assert_array_equal(a[:6 + plane], b[:6 + plane])
        assert np.abs(a[6 + plane:] - b[6 + plane:]).max() <= 1


@pytest.mark.parametrize("channels", [0, 1, 2])
def test_write_avi_matches_jax(tmp_path, jax_native, channels):
    """The AVI's bytes equal JAX's: video only, and with mono and stereo audio."""
    frames = _frames(n=4, seed=3)
    audio, sr = None, 0
    if channels:
        rng = np.random.default_rng(channels)
        audio = rng.integers(-2**15, 2**15, (1003, channels), dtype=np.int16)
        audio = audio[:, 0] if channels == 1 else audio
        sr = 8000
    TV.write_avi(str(tmp_path / "t.avi"), frames, fps=10, audio=audio, sample_rate=sr)
    JV.write_avi(str(tmp_path / "j.avi"), frames, fps=10, audio=audio, sample_rate=sr)
    got = _bytes(tmp_path / "t.avi")
    assert got[:4] == b"RIFF" and got[8:12] == b"AVI "
    assert (b"auds" in got) == bool(channels)
    assert got == _bytes(tmp_path / "j.avi")


def test_prefetch_ring_matches_read(tmp_path):
    """``iter_y4m_prefetched`` yields ``read_y4m / 255`` (the library multiplies
    by 1/255 in float32: within half an fp32 ulp of 1, 6e-8); closed after two
    frames of twenty it stops its producer and the next open reads afresh."""
    frames = _frames(n=20, h=16, w=32, seed=4)
    path = str(tmp_path / "p.y4m")
    TV.write_y4m(path, frames, fps=10)
    back = TV.read_y4m(path)[0].astype(np.float32) / 255.0
    got = np.stack(list(TV.iter_y4m_prefetched(path, depth=2)))
    assert got.shape == back.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, back, rtol=0, atol=6e-8)
    it = TV.iter_y4m_prefetched(path, depth=3)
    first = [next(it) for _ in range(2)]
    it.close()
    np.testing.assert_array_equal(np.stack(first), got[:2])
    np.testing.assert_array_equal(next(TV.iter_y4m_prefetched(path)), got[0])


@pytest.mark.parametrize("width", [1, 2])
def test_read_wav_matches_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, 2 * 500 * width, dtype=np.uint8).tobytes()
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(width)
        f.setframerate(11025)
        f.writeframes(raw)
    got, sr = TV.read_wav(path)
    want, jsr = JV.read_wav(path)
    assert sr == jsr == 11025 and got.dtype == np.int16 and got.shape == (500, 2)
    np.testing.assert_array_equal(got, want)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output; nothing falls back."""
    monkeypatch.setattr(TV, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TV, "GXX_FLAGS", TV.GXX_FLAGS + ("-DVFACE_IO_BROKEN", "-include", "no/such/header.h"))
    with pytest.raises(RuntimeError, match="building vface_io.cc failed"):
        TV.build()
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(TV, "GXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        TV.build()


def test_frames_are_validated(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        TV.write_y4m(str(tmp_path / "f.y4m"), np.zeros((1, 4, 4, 3), np.float32))
    with pytest.raises(IOError, match="cannot open"):
        TV.read_y4m(str(tmp_path / "missing.y4m"))


# ------------------------------------------------------------------ manifest
def test_manifest_reads_both_ways(tmp_path):
    """A manifest JAX wrote reads back the same in the port, and the other way round."""
    meta = {"window": 6, "ddim_steps": 50, "seed": 42}
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jm, tm = JManifest(jp, meta=meta), VideoProgressManifest(tp, meta=meta)
    for m in (jm, tm):
        m.mark_done(0, 6, ["0.png", "1.png"])
        m.mark_done(6, 3, ["6.png"])
    for reader, path in ((VideoProgressManifest, jp), (JManifest, tp)):
        m = reader(path, meta=meta)
        assert m.is_done(0) and m.is_done(6) and not m.is_done(12) and m.completed_frames() == 9
        assert m.data["windows"]["0"]["outputs"] == ["0.png", "1.png"] and m.data["meta"] == meta
    with open(jp) as f:
        j = json.load(f)
    with open(tp) as f:
        t = json.load(f)
    assert j.keys() == t.keys() and j["windows"].keys() == t["windows"].keys()
    assert all(j["windows"][k].keys() == t["windows"][k].keys() for k in j["windows"])


def test_manifest_meta_mismatch_discards_progress(tmp_path, capsys):
    """Both packages discard progress made under another fingerprint, each on
    the other's file; without a fingerprint the file is taken as it is."""
    path = str(tmp_path / "m.json")
    JManifest(path, meta={"window": 6}).mark_done(0, 6, ["0.png"])
    for reader in (VideoProgressManifest, JManifest):
        assert not reader(path, meta={"window": 3}).is_done(0)
        assert reader(path, meta={"window": 6}).is_done(0)
        assert reader(path).is_done(0)
    assert capsys.readouterr().out.count("discarding stale progress") == 2
    VideoProgressManifest(path, meta={"window": 3}).mark_done(3, 3, ["3.png"])
    m = JManifest(path, meta={"window": 3})
    assert m.is_done(3) and not m.is_done(0)


# ------------------------------------------------------------------ params
def test_load_params_npz_matches_from_flax_params(tmp_path):
    """The tiny bundle's npz, written by JAX's ``save_params_npz``, loads to
    exactly ``from_flax_params`` of the same tree, and into the port's model."""
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel

    tree = seeded_bundle_params(JModel(JConfig.tiny(image_size=32)), seed=5)
    path = str(tmp_path / "p.npz")
    save_params_npz(path, tree)
    got, want = load_params_npz(path), from_flax_params(tree)
    assert got.keys() == want.keys() == {"unet", "vae", "cond"}
    for part in want:
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and bool((got[part][k] == v).all()), (part, k)
    VFaceModel(ModelConfig.tiny(image_size=32), device="cpu", conditioner=True).load_params(got)


def test_load_params_npz_matches_from_flax_aux(tmp_path):
    """The aux nets' npz likewise equals ``from_flax_aux``; an unknown group raises."""
    import jax.numpy as jnp

    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.models.raft import RAFT, RAFTConfig
    from vface_tpu.preprocess.landmarks import load_default_landmark_params

    x = jnp.zeros((1, 32, 32, 3))
    tree = {"bisenet": seeded_flax_params(BiSeNet(), jnp.zeros((1, 64, 64, 3)), seed=6),
            "raft": seeded_flax_params(RAFT(RAFTConfig(iters=2)), x, x, seed=7),
            "landmark": jax.tree_util.tree_map(np.asarray, load_default_landmark_params())}
    path = str(tmp_path / "aux.npz")
    save_params_npz(path, tree)
    got, want = load_params_npz(path), from_flax_aux(tree)
    assert got.keys() == want.keys() == {"bisenet", "raft", "landmark"}
    for part in want:
        assert got[part].keys() == want[part].keys()
        assert all(bool((got[part][k] == v).all()) for k, v in want[part].items()), part
    save_params_npz(str(tmp_path / "bad.npz"), {"other": {"kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="unknown parameter groups"):
        load_params_npz(str(tmp_path / "bad.npz"))


# ------------------------------------------- GIF, PNG, masks and the config
def test_write_gif_matches_jax(tmp_path):
    """Both write through PIL (the card has it): the GIF's bytes are equal."""
    frames = _frames(n=3, seed=8)
    TV.write_gif(str(tmp_path / "t.gif"), frames, fps=10)
    JV.write_gif(str(tmp_path / "j.gif"), frames, fps=10)
    assert _bytes(tmp_path / "t.gif") == _bytes(tmp_path / "j.gif")


def test_png_frames_round_trip(tmp_path):
    """``write_png`` / ``read_png`` keep RGB and gray frames exactly (PNG is
    lossless) and convert as PIL does: RGB -> L by ITU-R 601-2 luma."""
    from PIL import Image

    from vface_torch.io.image import read_png, write_png

    rgb, gray = _frames(n=1, seed=9)[0], _frames(n=1, seed=10)[0, :, :, 0]
    write_png(str(tmp_path / "rgb.png"), rgb)
    write_png(str(tmp_path / "gray.png"), gray)
    np.testing.assert_array_equal(read_png(str(tmp_path / "rgb.png")), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "gray.png")), gray)
    np.testing.assert_array_equal(read_png(str(tmp_path / "gray.png"), mode="RGB"), np.repeat(gray[..., None], 3, -1))
    np.testing.assert_array_equal(read_png(str(tmp_path / "rgb.png"), mode="L"),
                                  np.asarray(Image.fromarray(rgb).convert("L")))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "f.png"), rgb.astype(np.float32) / 255.0)


def test_load_mask_matches_jax(tmp_path):
    """A parse map resized by nearest neighbour to the crop size, as JAX's loader."""
    from vface_torch.data.datasets import _load_mask
    from vface_torch.io.image import write_png
    from vface_tpu.data.datasets import _load_mask as j_load_mask

    m = np.random.default_rng(11).integers(0, 19, (45, 70), dtype=np.uint8)
    write_png(str(tmp_path / "m.png"), m)
    for size in (None, 32, 96):
        got, want = _load_mask(str(tmp_path / "m.png"), size), j_load_mask(str(tmp_path / "m.png"), size)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_load_yaml_matches_jax(tmp_path):
    """The config ``scripts/generate_config.py`` writes (with a ``masks:`` key) loads as in JAX."""
    from vface_torch.utils.config import load_yaml
    from vface_tpu.utils.config import load_yaml as j_load_yaml

    path = tmp_path / "pairs.yaml"
    path.write_text("- video: /data/v 1.y4m\n  source: /data/s1.png\n"
                    "- video: /data/v2\n  source: /data/s2.jpg\n  masks: /data/m2\n")
    got = load_yaml(str(path))
    assert got == j_load_yaml(str(path))
    assert got[1] == {"video": "/data/v2", "source": "/data/s2.jpg", "masks": "/data/m2"}


def test_registry_and_instantiate_from_config_match_jax():
    """register / build (and the KeyError naming the known names),
    get_obj_from_str and instantiate_from_config (a dotted target and its
    params; KeyError without a target), on both packages' copies."""
    from vface_torch.utils import config as TC
    from vface_tpu.utils import config as JC

    for mod in (TC, JC):
        mod.register("registry_test_pair")(lambda a, b=2: (a, b))
        assert mod.build("registry_test_pair", a=1) == (1, 2)
        with pytest.raises(KeyError, match="registry_test_pair"):
            mod.build("no_such_component")
        assert mod.get_obj_from_str("collections.OrderedDict") is collections.OrderedDict
        cfg = {"target": "fractions.Fraction", "params": {"numerator": 3, "denominator": 4}}
        assert mod.instantiate_from_config(cfg) == fractions.Fraction(3, 4)
        assert mod.instantiate_from_config({"target": "builtins.list"}) == []
        with pytest.raises(KeyError, match="target"):
            mod.instantiate_from_config({"params": {}})
