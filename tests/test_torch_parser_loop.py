"""The video loop with the BiSeNet parse against JAX's, stage by stage, on
``tests/test_torch_sharded_video.py``'s clip.

Tiny bundle ``tiny_video_bundle(7, seed=61)`` (7 frames of 48 x 64), window 2,
``SwapOptions(ddim_steps=2, inversion_steps=2, image_size=32, parser_size=64,
raft_iters=2, flow_tokens=256)``, fp32 on the CPU; one JAX loop records its
windows' inputs and outputs. The frames sit up to 3.4e-4 from JAX's. The
split by stage puts the whole gap at one stage, the VAE encode of the masked
crop (the inpaint latent): its first GroupNorm normalises a channel of std
0.013 around a mean of 0.074 with the one-pass variance E[x^2] - E[x]^2, and
there JAX's own fp32 result is 7.7e-3 from the float64 one while the port's
is 9.5e-5. Everything before it (crops, landmarks, parse logits, class
maps, keep-masks, flow, conditionings) is within 1e-4 of JAX, and every stage
after it on JAX's inputs (inversion, sampling, decode, paste). So the gap
is JAX's round-off amplified, not a port fault: JAX's own loop moves the
frames by up to 2.25e-4 under a 1e-6 change of the input frames (five of six
seeded draws; the sixth flipped a class at a parse tie: 0.72), and the frames
are held at 5e-4, twice that.

``PYTHONPATH=tests python tests/test_torch_parser_loop.py`` prints the stage
table and JAX's own motion (four more JAX loops: a few minutes).
"""

import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t, tiny_video_bundle
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

S, H, W, N = 32, 48, 64, 7
OPTS = dict(ddim_steps=2, inversion_steps=2, window=2, image_size=S, parser_size=64, raft_iters=2, flow_tokens=256)
FRAMES_LIMIT = 5e-4  # twice JAX's own largest motion under a 1e-6 input change, 2.25e-4


def _run():
    import jax.numpy as jnp

    from vface_tpu.pipelines.video_swap import SwapOptions as JOpts
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipe

    b = tiny_video_bundle(N, seed=61, s=S, hw=(H, W))
    jp = JPipe(b["jm"], JOpts(**OPTS))
    calls = {"window_conditionings": [], "swap_window_pasted": []}

    def spy(name, lead):
        real = getattr(jp, name)

        def call(*args, **kw):
            out = real(*args, **kw)
            calls[name].append(([None if a is None else np.asarray(a) for a in args[lead:]], np_tree(out)))
            return out
        return call

    jp.window_conditionings = spy("window_conditionings", 2)
    jp.swap_window_pasted = spy("swap_window_pasted", 1)
    want = np.asarray(jp.swap_video_frames(b["params"], b["jaux"], b["frames"], b["source"]))
    del jp.window_conditionings, jp.swap_window_pasted  # the class's methods again
    tp = VideoSwapPipeline(b["model"], SwapOptions(**OPTS), device="cpu", aux_params=b["aux"])
    return dict(b=b, jp=jp, tp=tp, want=want, calls=calls, frames=jnp.asarray(b["frames"]))


@pytest.fixture(scope="module")
def run():
    return _run()


def test_stages_before_the_encode_match_jax(run):
    """Crops and their inverse coefficients, landmarks, the parse logits at
    the parser's size (a class tie within 1.1e-5 is kept: the maps are equal),
    keep-masks, each window's flow and its conditionings from the recorded inputs."""
    from vface_tpu.models.bisenet import BiSeNet as JBiSeNet
    from vface_tpu.models.bisenet import parsing_preprocess as jprep
    from vface_tpu.preprocess.masks import TRAIN_REMOVE
    from vface_tpu.preprocess.masks import inpaint_inputs as jinpaint
    from vface_torch.models.bisenet import parsing_preprocess
    from vface_torch.preprocess.masks import inpaint_inputs

    b, jp, tp = run["b"], run["jp"], run["tp"]
    jc, jinv = jp.align_crops(b["jaux"], run["frames"])
    crops, inv = tp.align_crops(b["frames"])
    close(crops, jc, atol=1e-4)
    close(inv, jinv, atol=1e-4 * float(np.abs(np.asarray(jinv)).max()))
    close(tp.detect_landmarks(b["frames"]), jp.detect_landmarks(b["jaux"], run["frames"]), atol=1e-3)
    jlog = np.asarray(JBiSeNet().apply({"params": b["jaux"]["bisenet"]}, jprep(jc, 64)))
    with torch.no_grad():
        close(tp._net("bisenet")(parsing_preprocess(t(np.asarray(jc)), 64)), jlog, atol=1e-4)
    jseg = jp.parse_masks(b["jaux"], jc)
    seg = tp.parse_masks(crops)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    _, jkeep = jinpaint(jc * 2 - 1, jseg, TRAIN_REMOVE)
    np.testing.assert_array_equal(inpaint_inputs(crops * 2 - 1, seg, TRAIN_REMOVE)[1].numpy(), np.asarray(jkeep))
    recorded = run["calls"]["window_conditionings"]
    assert len(recorded) == 4
    for args, want in recorded:
        for g, w in zip(tp.window_conditionings(*args), want):
            close(g, w, atol=1e-5)
    for args, _ in run["calls"]["swap_window_pasted"]:
        flow = args[10]
        if flow is not None:
            close(tp.compute_flow((t(args[2]) + 1) / 2), flow, atol=1e-4)


def _masked_encode_gn(run, frame: int):
    """On the masked crop of ``frame``: (JAX's first encoder GroupNorm output,
    the port's on the same input, the float64 one) and the port's and JAX's
    inpaint latents."""
    from vface_tpu.models.vae import AutoencoderKL as JAE

    b, calls = run["b"], run["calls"]["swap_window_pasted"]
    w, i = divmod(frame, 2)
    crops, keep = calls[w][0][2], calls[w][0][3]
    x = (crops * keep)[i:i + 1]
    _, inter = b["jm"].vae.apply({"params": b["params"]["vae"]}, x, method=JAE.encode, capture_intermediates=True)
    enc = inter["intermediates"]["encoder"]
    j_in = np.asarray(enc["conv_in"]["__call__"][0])
    j_n1 = np.asarray(enc["down_0_block_0"]["norm1"]["__call__"][0])
    gn = run["tp"].model.vae.encoder.down_0_block_0.norm1
    with torch.no_grad():
        t_n1 = gn(t(j_in).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    x64 = j_in.astype(np.float64)
    mu, var = x64.mean(axis=(1, 2), keepdims=True), x64.var(axis=(1, 2), keepdims=True)
    exact = ((x64 - mu) / np.sqrt(var + gn.eps) * gn.weight.detach().numpy().astype(np.float64)
             + gn.bias.detach().numpy().astype(np.float64))
    z_jax = np.asarray(b["jm"].encode_first_stage(b["params"], x))
    with torch.no_grad():
        z_port = run["tp"].model.encode_first_stage(t(x)).numpy()
    return j_n1, t_n1, exact, z_jax, z_port


def test_the_masked_encode_amplifies_jax_round_off(run):
    """The stage that carries the gap: on frames 3 and 6 (the worst two) the
    inpaint latent is over 1e-4 from JAX's, and the first GroupNorm's output
    is nearer the float64 one in the port than in JAX, whose own fp32 error
    there is over 1e-3."""
    for frame in (3, 6):
        j_n1, t_n1, exact, z_jax, z_port = _masked_encode_gn(run, frame)
        jax_err, port_err = np.abs(j_n1 - exact).max(), np.abs(t_n1 - exact).max()
        assert jax_err > 1e-3 and port_err < jax_err / 10, (frame, jax_err, port_err)
        assert np.abs(z_port - z_jax).max() > 1e-4


def test_window_stages_after_the_encode_match_jax_on_its_inputs(run):
    """Window 2 (frames 2-3, with flow; the largest gap): on JAX's latents, the
    port's inversion start code, sampled latent, decode and paste are within 1e-4."""
    import jax
    import jax.numpy as jnp

    from vface_tpu.pipelines.video_swap import paste_back as jpaste
    from vface_tpu.pipelines.video_swap import resize_flow as jresize_flow
    from vface_tpu.samplers.inversion import ddim_invert as jinvert
    from vface_tpu.samplers.vface import vface_sample as jsample
    from vface_torch.preprocess.align import paste_back
    from vface_torch.samplers.inversion import ddim_invert
    from vface_torch.samplers.vface import vface_sample

    b, jp, tp = run["b"], run["jp"], run["tp"]
    jm, P, tm = b["jm"], b["params"], tp.model
    args, pasted = run["calls"]["swap_window_pasted"][1]
    frames_w, inv_w, c, km, cond, unc, invc, _, _, _, flow = args
    f, hl = c.shape[0], jm.cfg.latent_size
    z_inp = jm.encode_first_stage(P, c * km)
    mlat = jax.image.resize(jnp.asarray(km), (f, hl, hl, 1), method="bilinear")
    z_tar = jm.encode_first_stage(P, c)
    _, invl = jinvert(jm, P, z_tar, invc, z_inp, mlat, num_steps=2, keep=f, encoder_interval=1, skip_last=1)
    z0 = jsample(jm, P, invl[-1], cond, unc, invc, invl, z_inp, mlat, jp.injection,
                 flow=jresize_flow(jnp.asarray(flow), hl, hl), num_steps=2, cfg_scale=3.0, eta=0.0,
                 drop_recon_chunk=True)[0]
    out01 = jnp.clip((jm.decode_first_stage(P, z0) + 1.0) * 0.5, 0.0, 1.0)
    bg = jp.decode_with_background(P, jnp.asarray(frames_w) * 2.0 - 1.0)
    T = lambda a: t(np.asarray(a))
    with torch.inference_mode():
        close(tm.encode_first_stage(T(c)), z_tar, atol=1e-4)
        _, tinvl = ddim_invert(tm, T(z_tar), T(invc), T(z_inp), T(mlat), num_steps=2, keep=f, skip_last=1)
        close(tinvl[-1], invl[-1], atol=1e-4)
        tz0 = vface_sample(tm, T(invl[-1]), T(cond), T(unc), T(invc), T(invl), T(z_inp), T(mlat), tp.injection,
                           flow=tp._latent_flow(T(flow)), num_steps=2, cfg_scale=3.0, eta=0.0, noise=tp.noise,
                           drop_recon_chunk=True)[0]
        close(tz0, z0, atol=1e-4)
        close(tp._decode01(T(z0)), out01, atol=1e-4)
        close(tp.decode_with_background(T(frames_w) * 2.0 - 1.0), bg, atol=1e-4)
        close(paste_back(T(bg), T(out01), T(inv_w), 1.0 - T(km)), jpaste(bg, out01, inv_w, 1.0 - km), atol=1e-4)


def test_parser_loop_frames_within_jax_motion(run):
    got = run["tp"].swap_video_frames(run["b"]["frames"], run["b"]["source"])
    assert tuple(got.shape) == (N, H, W, 3)
    close(got, run["want"], atol=FRAMES_LIMIT)


def main():
    """The stage table and JAX's own motion under 1e-6 changes of the input frames."""
    r = _run()
    b, jp = r["b"], r["jp"]
    got = r["tp"].swap_video_frames(b["frames"], b["source"]).numpy()
    print("frames, port vs JAX, per frame:", np.abs(got - r["want"]).reshape(N, -1).max(1))
    for frame in range(N):
        j_n1, t_n1, exact, z_jax, z_port = _masked_encode_gn(r, frame)
        print(f"frame {frame}: inpaint latent port vs JAX {np.abs(z_port - z_jax).max():.3e}; first GroupNorm vs "
              f"float64: JAX {np.abs(j_n1 - exact).max():.3e}, port {np.abs(t_n1 - exact).max():.3e}")
    for k in range(4):
        rng = np.random.default_rng(200 + k)
        moved = (b["frames"] + 1e-6 * rng.choice([-1.0, 1.0], size=b["frames"].shape)).astype(np.float32)
        d = np.abs(np.asarray(jp.swap_video_frames(b["params"], b["jaux"], moved, b["source"])) - r["want"])
        print(f"JAX's own motion, draw {k}: {d.max():.3e}, per frame {d.reshape(N, -1).max(1)}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
