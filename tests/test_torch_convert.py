"""The port's checkpoint converters and npz writer against the JAX package's.

No torch checkpoint is in the repo, so each seeded torch state dict is made by
inverting the JAX converter (:func:`invert`): a JAX init tree's shapes at a
tiny (or, for the eval nets, the full) config are filled with seeded numpy,
and JAX's converter is replayed with its readers recording which torch key
and which layout (conv, linear, as is) each Flax leaf comes from; every leaf
is then written under that key in the torch layout. The inverse is proved
first: JAX's own converter gives back the tree bit for bit and ``verify_tree``
reports nothing. Only then is the port's converter held to it: the same
tree, bit for bit, and its state dicts load into the port's modules with
``strict=True``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_tree, seeded_tree
from vface_tpu.utils import sd_convert as JSD
from vface_tpu.utils import torch_convert as JTC
from vface_torch.utils import sd_convert as TSD
from vface_torch.utils import torch_convert as TTC
from vface_torch.utils.convert import flax_tree_to_state_dict, from_flax_params, from_flax_safety


class _Stray(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class _Tag:
    kind: str  # "conv", "linear" or "id": the reader that took the torch value
    key: str


class _Recording(dict):
    """The torch state dict as the converter sees it while it is replayed: every
    key is present unless it is known absent, and each read gives its key."""

    def __init__(self, absent):
        super().__init__()
        self.absent = absent
        self.last_yes = None

    def __contains__(self, key):
        yes = key not in self.absent
        if yes:
            self.last_yes = key
        return yes

    def __getitem__(self, key):
        return key


def _leaf_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_leaf_paths(v, p) if isinstance(v, dict) else {p: v})
    return out


@contextlib.contextmanager
def _replaying(init_paths, rec):
    """JAX's readers return tags; a write outside the init tree is stray: the key
    whose presence the converter last asked about is then absent."""
    saved = {(m, n): getattr(m, n) for m in (JTC, JSD) for n in ("_t", "conv_kernel", "linear_kernel", "set_path")}
    real_set = JTC.set_path

    def set_path(tree, path, value):
        if path not in init_paths:
            raise _Stray(rec.last_yes)
        real_set(tree, path, value)

    for m in (JTC, JSD):
        m._t = lambda x: _Tag("id", x)
        m.conv_kernel = lambda x: _Tag("conv", x)
        m.linear_kernel = lambda x: _Tag("linear", x)
        m.set_path = set_path
    try:
        yield
    finally:
        for (m, n), f in saved.items():
            setattr(m, n, f)


def invert(convert, init_tree, absent=()):
    """(torch state dict, the tree JAX's converter should give back): each leaf of
    ``init_tree`` under the key the converter reads it from, in the torch
    layout; leaves the converter fills with constants (RAFT's zero conv
    biases, identity instance norms) take those constants in the tree."""
    init_paths = _leaf_paths(init_tree)
    absent = set(absent)
    while True:
        rec = _Recording(absent)
        try:
            with _replaying(init_paths, rec):
                got = convert(rec)
            break
        except _Stray as e:
            assert e.args[0] is not None and e.args[0] not in absent, "a write outside the tree with nothing to blame"
            absent.add(e.args[0])
    sd, want = {}, {}
    for path, leaf in _leaf_paths(got).items():
        v = np.asarray(init_paths[path], np.float32)
        if isinstance(leaf, _Tag):
            sd[leaf.key] = torch.from_numpy(np.ascontiguousarray(
                {"conv": lambda a: a.transpose(3, 2, 0, 1), "linear": lambda a: a.T, "id": lambda a: a}[leaf.kind](v)))
            JTC.set_path(want, path, v)
        else:
            JTC.set_path(want, path, np.asarray(leaf))
    return sd, want


def _equal_trees(got, want):
    gp, wp = _leaf_paths(got), _leaf_paths(want)
    assert sorted(gp) == sorted(wp)
    for p in wp:
        assert np.asarray(gp[p]).dtype == np.asarray(wp[p]).dtype and np.array_equal(gp[p], wp[p]), p


def _shapes(module, *inputs, seed=0):
    """A Flax module's seeded param tree as numpy (structure from ``eval_shape``: nothing is compiled)."""
    return np_tree(seeded_tree(jax.eval_shape(lambda r: module.init(r, *inputs)["params"], jax.random.PRNGKey(0)),
                               seed))


def _img(s):
    return jnp.zeros((1, s, s, 3))


def _round_trip(name, jconvert, tconvert, tree, absent=()):
    sd, want = invert(jconvert, tree, absent)
    got = jconvert(sd)
    _equal_trees(got, want)
    assert JTC.verify_tree(got, tree) == []
    port = tconvert(sd)
    _equal_trees(port, want)
    assert TTC.verify_tree(port, tree) == []
    return sd, port


# ------------------------------------------------------- torch_convert nets


def _aux_cases():
    from vface_tpu.eval.expression import FaceReconNet
    from vface_tpu.eval.fid import InceptionV3Pool3
    from vface_tpu.eval.lpips import LPIPS
    from vface_tpu.eval.pose import Hopenet
    from vface_tpu.models.arcface import IRSE50
    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.models.raft import RAFT, RAFTConfig

    return {
        "arcface": (lambda: _shapes(IRSE50(), _img(112), seed=1), "convert_arcface"),
        "bisenet": (lambda: _shapes(BiSeNet(), _img(64), seed=2), "convert_bisenet"),
        "hopenet": (lambda: _shapes(Hopenet(), _img(224), seed=3), "convert_hopenet"),
        "lpips": (lambda: _shapes(LPIPS(), _img(64), _img(64), seed=4), "convert_lpips"),
        "inception": (lambda: _shapes(InceptionV3Pool3(), _img(299), seed=5), "convert_fid_inception"),
        "raft": (lambda: _shapes(RAFT(RAFTConfig(iters=2)), _img(32), _img(32), seed=6), "convert_raft"),
        "facerecon": (lambda: _shapes(FaceReconNet(), _img(224), seed=7), "convert_face_recon"),
    }


def _port_module(name):
    from vface_torch.eval.expression import FaceReconNet
    from vface_torch.eval.fid import InceptionV3Pool3
    from vface_torch.eval.lpips import LPIPS
    from vface_torch.eval.pose import Hopenet
    from vface_torch.models.arcface import IRSE50
    from vface_torch.models.bisenet import BiSeNet
    from vface_torch.models.raft import RAFT

    return {"arcface": IRSE50, "bisenet": BiSeNet, "hopenet": Hopenet, "lpips": LPIPS, "inception": InceptionV3Pool3,
            "raft": RAFT, "facerecon": FaceReconNet}[name]()


def _face_recon_sd(tree, sd):
    """The head's inverse: the 257-d Dense is REFace's seven 1x1 convs in
    ``split_coeff``'s order (id 80, exp 64, tex 80, angle 3, gamma 27, tx_ty 2, tz 1)."""
    k, b = tree["fc"]["kernel"], tree["fc"]["bias"]
    bounds = np.cumsum([0, 80, 64, 80, 3, 27, 2, 1])
    for i in range(7):
        sd[f"final_layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(k[:, bounds[i]:bounds[i + 1]].T[:, :, None, None]))
        sd[f"final_layers.{i}.bias"] = torch.from_numpy(np.ascontiguousarray(b[bounds[i]:bounds[i + 1]]))
    return sd


@pytest.mark.parametrize("name", ["arcface", "bisenet", "hopenet", "lpips", "inception", "raft", "facerecon"])
def test_torch_convert_matches_jax_and_loads_strictly(name):
    make, fn = _aux_cases()[name]
    tree = make()
    jconvert, tconvert = getattr(JTC, fn), getattr(TTC, fn)
    if name == "facerecon":  # the trunk by replay, the fused head by its own inverse
        def trunk(sd):
            t = {}
            JTC.convert_resnet50_trunk(sd, t, src="backbone", out="backbone")
            return t
        sd, want = invert(trunk, {"backbone": tree["backbone"]})
        sd = _face_recon_sd(tree, sd)
        want["fc"] = tree["fc"]
        _equal_trees(jconvert(sd), want)
        assert JTC.verify_tree(jconvert(sd), tree) == []
        port = tconvert(sd)
        _equal_trees(port, want)
    else:
        sd, port = _round_trip(name, jconvert, tconvert, tree)
    net = _port_module(name)
    net.load_state_dict(flax_tree_to_state_dict(port), strict=True)
    if name in ("bisenet", "raft"):
        got = TTC.aux_state_dicts({name: sd})[name]
    elif name == "lpips":
        got = TTC.lpips_state_dict(sd)
    else:
        got = TTC.eval_state_dicts({name: sd})[name]
    want_sd = flax_tree_to_state_dict(port)
    assert sorted(got) == sorted(want_sd) and all(torch.equal(got[k], want_sd[k]) for k in got)


def test_layout_helpers_match_jax():
    r = np.random.default_rng(0)
    w4, w2 = r.normal(size=(8, 3, 5, 7)).astype(np.float32), r.normal(size=(6, 9)).astype(np.float32)
    for a in (w4, torch.from_numpy(w4)):
        np.testing.assert_array_equal(TTC.conv_kernel(a), JTC.conv_kernel(a))
    np.testing.assert_array_equal(TTC.linear_kernel(torch.from_numpy(w2)), JTC.linear_kernel(w2))
    tj, tt = {}, {}
    JTC.set_path(tj, "a/b/c", w2)
    TTC.set_path(tt, "a/b/c", w2)
    _equal_trees(tt, tj)
    bad = {"a": {"b": {"c": w2[:3]}, "x": w2}}
    assert TTC.verify_tree(bad, tj) == JTC.verify_tree(bad, tj) != []


# --------------------------------------------------------- sd_convert parts


def _tiny_bundle_tree():
    from vface_tpu.models import ModelConfig, VFaceModel

    jm = VFaceModel(ModelConfig.tiny())
    return jm, np_tree(seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 11))


def test_sd_unet_and_vae_convert_match_jax_and_load_strictly():
    from vface_torch.models.ldm import ModelConfig, VFaceModel

    jm, tree = _tiny_bundle_tree()
    cfg = jm.cfg
    tcfg = ModelConfig.tiny()
    sd_u, port_u = _round_trip("unet", lambda sd: JSD.convert_sd_unet(sd, cfg.unet),
                               lambda sd: TSD.convert_sd_unet(sd, tcfg.unet), tree["unet"])
    sd_v, port_v = _round_trip("vae", lambda sd: JSD.convert_sd_vae(sd, cfg.vae),
                               lambda sd: TSD.convert_sd_vae(sd, tcfg.vae), tree["vae"])
    assert all(k.startswith("model.diffusion_model.") for k in sd_u)
    assert all(k.startswith("first_stage_model.") for k in sd_v)
    model = VFaceModel(tcfg, device="cpu")
    model.unet.load_state_dict(flax_tree_to_state_dict(port_u), strict=True)
    model.vae.load_state_dict(flax_tree_to_state_dict(port_v), strict=True)
    both = TSD.model_state_dicts({**sd_u, **sd_v}, tcfg)
    model.load_params(both)
    assert all(torch.equal(both["unet"][k], v) for k, v in flax_tree_to_state_dict(port_u).items())


def test_conditioner_converters_match_jax_and_load_strictly():
    """The conditioner's three sources: the CLIP vision tower, projection and
    mapper2 (``cond_stage_model``; mapper2's q/k/v fused in ``c_qkv`` as xf.py
    has them), the ArcFace IR-SE-50 and the REFace heads on the LDM itself."""
    from vface_torch.models.conditioning import Conditioner, ConditionerConfig

    jm, tree = _tiny_bundle_tree()
    cond = tree["cond"]
    clip = cond["clip_encoder"]
    n_map = sum(k.startswith("mapper2_") for k in clip)
    layers = sum(k.startswith("layer_") for k in clip["vision"])
    p = "cond_stage_model.mapper2.resblocks"
    fused = {f"{p}.{i}.attn.c_qkv.weight" for i in range(n_map)}
    jconv = lambda sd: JSD.convert_clip_conditioner(sd, layers=layers)
    sd, want = invert(jconv, clip, absent=fused)
    for i in range(n_map):  # the fused projection's inverse
        a = clip[f"mapper2_{i}"]["attn"]
        sd[f"{p}.{i}.attn.c_qkv.weight"] = torch.from_numpy(np.concatenate([a[n]["kernel"].T for n in "qkv"]))
        sd[f"{p}.{i}.attn.c_qkv.bias"] = torch.from_numpy(np.concatenate([a[n]["bias"] for n in "qkv"]))
        sd[f"{p}.{i}.attn.c_proj.weight"] = torch.from_numpy(np.ascontiguousarray(a["out"]["kernel"].T))
        sd[f"{p}.{i}.attn.c_proj.bias"] = torch.from_numpy(a["out"]["bias"])
    _equal_trees(jconv(sd), clip)
    port_clip = TSD.convert_clip_conditioner(sd, layers=layers)
    _equal_trees(port_clip, clip)

    heads = {k: v for k, v in cond.items() if k not in ("clip_encoder", "arcface")}
    sd_h, port_h = _round_trip("heads", JSD.convert_reface_heads, TSD.convert_reface_heads, heads)
    sd_a, port_a = _round_trip("arcface", JTC.convert_arcface, TTC.convert_arcface, cond["arcface"])
    whole = {"clip_encoder": port_clip, "arcface": port_a, **port_h}
    net = Conditioner(ConditionerConfig.tiny())
    net.load_state_dict(from_flax_params({"cond": whole})["cond"], strict=True)


def test_clip_text_and_safety_converters_match_jax_and_load_strictly():
    from vface_tpu.models.clip import CLIPTextConfig as JText
    from vface_tpu.models.clip import CLIPTextEncoder as JEnc
    from vface_tpu.models.clip import CLIPVisionConfig as JVis
    from vface_tpu.models.clip import CLIPVisionTower as JTower
    from vface_torch.models.clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionTower

    cfg = JText.tiny()
    tree = _shapes(JEnc(cfg), jnp.zeros((1, 4), jnp.int32), seed=12)
    for prefix in ("", "clip."):
        conv = lambda sd, f=JSD.convert_clip_text_encoder: f(sd, layers=cfg.layers, prefix=prefix)
        sd, port = _round_trip("text", conv, lambda sd: TSD.convert_clip_text_encoder(sd, layers=cfg.layers,
                                                                                    prefix=prefix), tree)
        assert f"{prefix}text_model.embeddings.token_embedding.weight" in sd
    net = CLIPTextEncoder(CLIPTextConfig.tiny())
    net.load_state_dict(flax_tree_to_state_dict(port), strict=True)
    got = TSD.clip_text_state_dict(sd, layers=cfg.layers, prefix="clip.")
    assert all(torch.equal(got[k], v) for k, v in flax_tree_to_state_dict(port).items())

    vis = _shapes(JTower(JVis.tiny()), _img(32), seed=13)
    r = np.random.default_rng(14)
    arrays = {"visual_projection": r.normal(size=(64, 48)).astype(np.float32),
              "concept_embeds": r.normal(size=(17, 48)).astype(np.float32),
              "concept_thresholds": r.uniform(size=(17,)).astype(np.float32),
              "special_care_embeds": r.normal(size=(3, 48)).astype(np.float32),
              "special_care_thresholds": r.uniform(size=(3,)).astype(np.float32)}
    safety = {"clip": vis, **arrays}
    count_key = f"vision_model.vision_model.encoder.layers.{JVis.tiny().layers}.layer_norm1.weight"
    sd, port = _round_trip("safety", JSD.convert_safety_checker, TSD.convert_safety_checker, safety,
                           absent={count_key})
    params = TSD.safety_params(sd)
    assert params.keys() == from_flax_safety(safety).keys()
    tower = CLIPVisionTower(CLIPVisionConfig.tiny())
    tower.load_state_dict(params["clip"], strict=True)
    for k in arrays:
        np.testing.assert_array_equal(params[k], arrays[k])


def test_expand_conv_in_matches_jax():
    k = np.random.default_rng(15).normal(size=(3, 3, 4, 32)).astype(np.float32)
    got, want = TSD.expand_conv_in_4_to_9(k), JSD.expand_conv_in_4_to_9(k)
    assert got.shape == (3, 3, 9, 32) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the npz writer


def test_save_params_npz_round_trips_through_both_loaders(tmp_path):
    """A converted bundle written by the port: JAX's ``load_params_npz`` reads
    the init tree back bit for bit, the port's loader gives the same state
    dicts as ``from_flax_params``, and the file equals JAX's own writer's."""
    from vface_tpu.runtime.checkpoint import load_params_npz as jload
    from vface_tpu.runtime.checkpoint import save_params_npz as jsave
    from vface_torch.runtime.checkpoint import load_params_npz, save_params_npz

    _, tree = _tiny_bundle_tree()
    tree = {"unet": tree["unet"], "vae": tree["vae"], "extra": [np.arange(3, dtype=np.float32)]}
    path, jpath = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_params_npz(str(path), tree)
    jsave(str(jpath), tree)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)
    back = jload(str(path), tree)
    _equal_trees(np_tree({"unet": back["unet"], "vae": back["vae"]}), {"unet": tree["unet"], "vae": tree["vae"]})
    save_params_npz(str(path), {"unet": tree["unet"], "vae": tree["vae"]})
    got, want = load_params_npz(str(path)), from_flax_params(tree)
    for part in ("unet", "vae"):
        assert sorted(got[part]) == sorted(want[part])
        assert all(torch.equal(got[part][k], want[part][k]) for k in got[part])
    # torch tensors are written as arrays
    save_params_npz(str(path), {"a": {"kernel": torch.ones(2, 3)}})
    with np.load(path) as a:
        np.testing.assert_array_equal(a["a/kernel"], np.ones((2, 3), np.float32))
