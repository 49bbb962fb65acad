"""The slice as a whole: the port's ``swap_video_frames`` and its stages against JAX's.

The session's tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner
included), fp32 on the CPU, ``SwapOptions(ddim_steps=2, inversion_steps=2,
window=3, image_size=32, parser_size=64, raft_iters=2)`` with
``flow_tokens=256`` so that FSAI and FGATS engage at the tiny latent (16^2
tokens); aux nets: BiSeNet and RAFT from seeded numpy weights, the landmark net
from the shipped file. Four non-square frames (48 x 64): a 3-frame window with
flow and a 1-frame window without. One module-scoped JAX pipeline runs the
video twice (with the parser; with precomputed keep-masks), recording the
inputs and outputs of its window stages; the port runs the same calls.

Tolerances: fp32 round-off through the conditioner (1e-5), through the VAE,
two inversion and two sampling steps, the background trick and paste-back
(1e-4 on images in [0, 1]).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_flax_params, t
from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline
from vface_tpu.preprocess.landmarks import load_default_landmark_params
from vface_torch.bench import randn as bench_randn
from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
from vface_torch.utils.convert import from_flax_aux, from_flax_params

OPTS = dict(ddim_steps=2, inversion_steps=2, window=3, image_size=32, parser_size=64, raft_iters=2, flow_tokens=256)
N, H, W, S = 4, 48, 64, 32


def _smooth(shape, seed):
    """Seeded smooth images in [0, 1] (low-frequency noise, upsampled)."""
    n, h, w, _ = shape
    base = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    return torch.sigmoid(up).permute(0, 2, 3, 1).numpy().copy()


def _keep(n):
    yy, xx = np.mgrid[:S, :S]
    face = ((yy - S * 0.55) / (S * 0.3)) ** 2 + ((xx - S * 0.5) / (S * 0.24)) ** 2 <= 1.0
    return np.broadcast_to((~face).astype(np.float32)[None, :, :, None], (n, S, S, 1)).copy()


@pytest.fixture(scope="module")
def run(tiny_bundle):
    import jax.numpy as jnp

    jm, params = tiny_bundle
    jpipe = JPipeline(jm, JSwapOptions(**OPTS))
    aux = {"bisenet": seeded_flax_params(jpipe.bisenet, jnp.zeros((1, 64, 64, 3)), seed=1),
           "raft": seeded_flax_params(jpipe.raft, jnp.zeros((1, S, S, 3)), jnp.zeros((1, S, S, 3)), seed=2),
           "landmark": load_default_landmark_params()}
    calls = {"window_conditionings": [], "swap_window_pasted": []}

    def spy(name, lead):  # lead: the JAX call's leading param trees, which the port's lacks
        real = getattr(jpipe, name)

        def call(*args, **kw):
            out = real(*args, **kw)
            calls[name].append(([None if a is None else np.asarray(a) for a in args[lead:]], np_tree(out)))
            return out
        return call

    setattr(jpipe, "window_conditionings", spy("window_conditionings", 2))  # (params, aux_params, ...)
    setattr(jpipe, "swap_window_pasted", spy("swap_window_pasted", 1))  # (params, ...)
    frames, source = _smooth((N, H, W, 3), seed=3), _smooth((1, H, W, 3), seed=4)[0]
    keep = _keep(N)
    want = {"parser": np.asarray(jpipe.swap_video_frames(params, aux, frames, source))}
    recorded = {k: list(v) for k, v in calls.items()}
    want["keep"] = np.asarray(jpipe.swap_video_frames(params, aux, frames, source, frame_keep=keep,
                                                      source_keep=keep[0]))
    stages = {"crops": jpipe.align_crops(aux, jnp.asarray(frames))}
    stages["seg"] = jpipe.parse_masks(aux, stages["crops"][0])
    stages["flow"] = jpipe.compute_flow(aux, stages["crops"][0][:3])
    stages["landmarks"] = jpipe.detect_landmarks(aux, jnp.asarray(frames))
    model = VFaceModel(ModelConfig.tiny(image_size=S), device="cpu", conditioner=True)
    model.load_params(from_flax_params(np_tree(params)))
    taux = from_flax_aux(np_tree(aux))
    tpipe = VideoSwapPipeline(model, SwapOptions(**OPTS), device="cpu", aux_params=taux)
    return dict(jm=jm, params=params, tpipe=tpipe, aux=taux, frames=frames, source=source, keep=keep, want=want, calls=recorded,
                stages=np_tree(stages))


def test_align_parse_flow_stages_match_jax(run):
    """Landmarks 1e-3 px, crops and inverse coefficients (the quads' fp32
    round-off), class maps equal, flow 1e-4 px."""
    tp, st = run["tpipe"], run["stages"]
    close(tp.detect_landmarks(run["frames"]), st["landmarks"], atol=1e-3)
    crops, coeffs = tp.align_crops(run["frames"])
    close(crops, st["crops"][0], atol=1e-4)
    close(coeffs, st["crops"][1], atol=1e-4 * float(np.abs(st["crops"][1]).max()))
    np.testing.assert_array_equal(tp.parse_masks(t(st["crops"][0])).numpy(), st["seg"])
    close(tp.compute_flow(t(st["crops"][0][:3])), st["flow"], atol=1e-4)


def test_window_conditionings_match_jax(run):
    """Both windows' (cond, uncond, inverse_cond, cond_w_src) from the recorded inputs: 1e-5."""
    recorded = run["calls"]["window_conditionings"]
    assert len(recorded) == 2
    for args, want in recorded:
        got = run["tpipe"].window_conditionings(*args)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            close(g, w, atol=1e-5)


def test_swap_window_pasted_matches_jax(run):
    """The 3-frame window (with flow) and the 1-frame window (without), pasted
    into the full frames, from the recorded inputs: 1e-4."""
    recorded = run["calls"]["swap_window_pasted"]
    assert [args[-1] is None for args, _ in recorded] == [False, True]
    for args, want in recorded:
        timings = {}
        got = run["tpipe"].swap_window_pasted(*args, timings=timings)
        assert tuple(got.shape) == want.shape and {"encode", "background", "paste_back"} <= set(timings)
        close(got, want, atol=1e-4)


def test_decode_with_background_res_matches_jax(run):
    """``background_res`` r = 16 on two square 32 x 32 frames: the VAE round
    trip at 16^2 and the bilinear resize back, within 1e-4 of JAX's."""
    frames = _smooth((2, S, S, 3), seed=5) * 2.0 - 1.0
    opts = {**OPTS, "background_res": 16}
    want = jax.jit(JPipeline(run["jm"], JSwapOptions(**opts)).decode_with_background)(run["params"], frames)
    got = VideoSwapPipeline(run["tpipe"].model, SwapOptions(**opts), device="cpu").decode_with_background(frames)
    assert tuple(got.shape) == (2, S, S, 3)
    close(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("mode", ["parser", "keep"])
def test_swap_video_frames_matches_jax(run, mode):
    """The whole call on 4 frames of 48 x 64: 1e-4 of JAX's, with the parser and
    with precomputed keep-masks for the frames and the source."""
    kw = {} if mode == "parser" else dict(frame_keep=run["keep"], source_keep=run["keep"][0])
    timings = {}
    got = run["tpipe"].swap_video_frames(run["frames"], run["source"], timings=timings, **kw)
    assert got.shape == (N, H, W, 3) and got.device.type == "cpu"
    assert {"align", "flow", "conditionings", "sample", "background", "paste_back"} <= set(timings)
    close(got, run["want"][mode], atol=1e-4)


UNPORTED = {  # eta and encoder_interval run: tests/test_torch_video_opts.py; the carry: test_torch_carry.py
    "eta": (dict(eta=0.5, encoder_interval=2, cross_window_carry=True), {}),
    "encoder_interval": (dict(encoder_interval=2, cross_window_carry=True), {}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_paths_raise(run, case):
    """The one combination of the sampler options that the JAX package cannot
    run, encoder propagation with the cross-window carry (its ``lax.cond``
    cannot join a cached step's empty carry to a key step's), with and
    without eta > 0: the port refuses it too."""
    fields, kw = UNPORTED[case]
    pipe = VideoSwapPipeline(run["tpipe"].model, SwapOptions(**{**OPTS, **fields}), device="cpu",
                             aux_params=run["aux"])
    with pytest.raises(ValueError, match="encoder_interval"):
        pipe.swap_video_frames(run["frames"], run["source"], frame_keep=run["keep"], source_keep=run["keep"][0],
                               **kw)


def test_failed_eligibility_runs_the_sequential_loop(run):
    """invert_packs=2 on 4 frames with window 3 (fewer than two windows): JAX's
    super-pack test fails and it runs the sequential loop; so does the port."""
    pipe = VideoSwapPipeline(run["tpipe"].model, SwapOptions(**{**OPTS, "invert_packs": 2}), device="cpu",
                             aux_params=run["aux"])
    got = pipe.swap_video_frames(run["frames"], run["source"], frame_keep=run["keep"], source_keep=run["keep"][0])
    close(got, run["want"]["keep"], atol=1e-4)


def test_video_entry_points_default_to_cuda():
    """Without CUDA the pipeline and the benches' inputs raise unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = VFaceModel(ModelConfig.tiny(), device="cpu", conditioner=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoSwapPipeline(model, SwapOptions(image_size=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_randn((2, 2), seed=0)
    assert VideoSwapPipeline(model, SwapOptions(image_size=32), device="cpu").device.type == "cpu"
