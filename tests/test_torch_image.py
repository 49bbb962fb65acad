"""The image path against the JAX package's: ``swap_image_batch``,
``run_test_bench``, ``plms_sample`` and ``ddim_sample_guided``.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, its conditioner included)
with seeded params that hold no zero convolution, fp32 on the CPU; the
landmark net from its shipped weights. JAX's image core draws x_T from
``PRNGKey(42)`` on every call; the port's calls are handed a source that
gives JAX's x_T (:func:`jax_x_T`).

Limits: z_0, trajectories and swapped crops within 1e-4 (a few CFG evals,
the scale amplifying each eps difference; the decode after them); PLMS
within 1e-5 of the peak (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_bundle_params, t
from vface_torch.pipelines import image_swap
from vface_torch.pipelines.image_swap import ImageSwapOptions, run_test_bench, swap_image_batch
from vface_torch.samplers.guided import ddim_sample_guided
from vface_torch.samplers.plms import plms_sample

B, S, HL, D = 2, 32, 16, 64  # batch, image side, latent side (the tiny VAE halves), context width
STEPS = 4  # a divisor of 1000


def jax_x_T():
    """A noise source giving the JAX image core's x_T: the normal draw at the
    asked shape from the first half of ``split(PRNGKey(42))``."""
    def noise(idx, shape):
        r_noise, _ = jax.random.split(jax.random.PRNGKey(42))
        return torch.from_numpy(np.array(jax.random.normal(r_noise, shape, jnp.float32)))
    return noise


@pytest.fixture(scope="module")
def bundle():
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.preprocess.landmarks import load_default_landmark_params
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import from_flax_aux, from_flax_params

    jm = JModel(JConfig.tiny(image_size=S))
    params = seeded_bundle_params(jm, seed=81)
    model = VFaceModel(ModelConfig.tiny(image_size=S), device="cpu", conditioner=True)
    model.load_params(from_flax_params(np_tree(params)))
    jaux = {"landmark": load_default_landmark_params()}
    r = np.random.default_rng(82)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    yy, xx = np.mgrid[:S, :S]
    face = ((yy - S * 0.55) / (S * 0.3)) ** 2 + ((xx - S * 0.5) / (S * 0.24)) ** 2 <= 1.0
    keep = np.broadcast_to((~face).astype(np.float32)[None, :, :, None], (B, S, S, 1)).copy()
    emb = n(B, 512)
    data = dict(target=np.tanh(n(B, S, S, 3)), keep=keep, src_clip=n(B, S, S, 3), src01=r.uniform(size=(B, S, S, 3))
                .astype(np.float32), lms=(r.uniform(size=(B, 136)) * S).astype(np.float32), x_T=n(B, HL, HL, 4),
                cond=n(B, 1, D), uncond=n(B, 1, D), inpaint=n(B, HL, HL, 4),
                mask=(r.uniform(size=(B, HL, HL, 1)) > 0.5).astype(np.float32),
                emb=emb / np.linalg.norm(emb, axis=-1, keepdims=True))
    return dict(jm=jm, params=params, model=model, jaux=jaux, aux=from_flax_aux(np_tree(jaux)), d=data)


def test_swap_image_batch_matches_jax(bundle):
    """The device core (conditioning, inpaint encode, 4-step CFG DDIM, decode)
    on JAX's x_T: within 1e-4 of JAX's; [0, 1]; the stage clock sees every stage."""
    from vface_tpu.pipelines.image_swap import ImageSwapOptions as JOptions
    from vface_tpu.pipelines.image_swap import swap_image_batch as jax_swap

    d = bundle["d"]
    args = [d[k] for k in ("target", "keep", "src_clip", "src01", "lms")]
    want = jax_swap(bundle["jm"], bundle["params"], *map(jnp.asarray, args), JOptions(STEPS, 3.0, S))
    timings = {}
    got = swap_image_batch(bundle["model"], *map(t, args), ImageSwapOptions(STEPS, 3.0, S), noise=jax_x_T(),
                           timings=timings)
    assert tuple(got.shape) == (B, S, S, 3) and float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    close(got, np.asarray(want), atol=1e-4)
    assert set(timings) == {"conditioning", "encode", "sample", "decode"}


def _pairs():
    """Four test-bench pairs, the last two the first two's images under other names."""
    r = np.random.default_rng(83)
    yy, xx = np.mgrid[:S, :S]
    pairs = []
    for i in range(2):
        mask = np.where(((yy - 17) / 9.0) ** 2 + ((xx - 16 - i) / 7.0) ** 2 <= 1.0, 1, 0).astype(np.int32)
        mask[(yy < 10) & (np.abs(xx - 16) < 6)] = 17
        pairs.append({"source": np.tanh(r.normal(size=(S, S, 3))).astype(np.float32),
                      "target": np.tanh(r.normal(size=(S, S, 3))).astype(np.float32), "mask": mask})
    return [dict(p, name=f"p{i}") for i, p in enumerate(pairs + pairs)]


@pytest.fixture(scope="module")
def benches(bundle):
    from vface_tpu.pipelines.image_swap import ImageSwapOptions as JOptions
    from vface_tpu.pipelines.image_swap import run_test_bench as jax_bench

    want = dict(jax_bench(bundle["jm"], bundle["params"], bundle["jaux"], _pairs(), JOptions(STEPS, 3.0, S),
                          batch_size=2))
    got = dict(run_test_bench(bundle["model"], bundle["aux"], _pairs(), ImageSwapOptions(STEPS, 3.0, S),
                              batch_size=2, noise=jax_x_T()))
    seeded = dict(run_test_bench(bundle["model"], bundle["aux"], _pairs(), ImageSwapOptions(STEPS, 3.0, S),
                                 batch_size=2))
    return want, got, seeded


def test_run_test_bench_matches_jax(benches):
    """Two batches of two pairs: every swap within 1e-4 of JAX's (the port
    handed JAX's x_T), by name, in the pairs' order."""
    want, got, _ = benches
    assert list(got) == list(want) == ["p0", "p1", "p2", "p3"]
    for name in want:
        assert got[name].shape == (S, S, 3)
        close(got[name], want[name], atol=1e-4)


def test_every_batch_starts_from_the_same_x_T(benches):
    """The second batch holds the first's images: in JAX, in the port on JAX's
    x_T and in the port on its own seeded x_T (a generator seeded with 42
    afresh per call), its swaps equal the first batch's; the seeded x_T is
    not JAX's, so those swaps differ from JAX's."""
    want, got, seeded = benches
    for run in (want, got, seeded):
        for a, b in (("p0", "p2"), ("p1", "p3")):
            np.testing.assert_array_equal(run[a], run[b])
    assert np.abs(seeded["p0"] - want["p0"]).max() > 1e-3


def test_default_noise_is_seeded_42_per_call(bundle):
    """The default x_T is a fresh generator seeded with 42 on the model's device, per call."""
    calls = []
    real = image_swap.seeded_noise

    def spy(device, seed=0):
        calls.append((torch.device(device).type, seed))
        return real(device, seed)

    d = bundle["d"]
    args = [t(d[k]) for k in ("target", "keep", "src_clip", "src01", "lms")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(image_swap, "seeded_noise", spy)
        a = swap_image_batch(bundle["model"], *args, ImageSwapOptions(1, 3.0, S))
        b = swap_image_batch(bundle["model"], *args, ImageSwapOptions(1, 3.0, S))
    assert calls == [("cpu", 42), ("cpu", 42)]
    assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [STEPS, 3], ids=["divisor", "non_divisor"])
def test_plms_sample_matches_jax(bundle, steps):
    """PLMS (Heun warm-up, then AB2, AB3, AB4): z_0 and the pred_x0 trajectory
    within 1e-5 of JAX's at their peak (|pred_x0| reaches 19-34 on the random
    weights, and the multistep weights, up to 59/24, carry each step's
    round-off on); 3 steps run the table of a non-divisor, as JAX's does."""
    from vface_tpu.samplers.plms import plms_sample as jax_plms

    d = bundle["d"]
    args = [d[k] for k in ("x_T", "cond", "uncond", "inpaint", "mask")]
    wz, wtraj = jax_plms(bundle["jm"], bundle["params"], *map(jnp.asarray, args), num_steps=steps, cfg_scale=3.0)
    with torch.inference_mode():
        z, traj = plms_sample(bundle["model"], *map(t, args), num_steps=steps, cfg_scale=3.0)
    assert traj.shape == wtraj.shape
    for got, want in ((z, wz), (traj, wtraj)):
        want = np.asarray(want)
        close(got, want, atol=1e-5 * float(np.abs(want).max()))


def test_plms_evals_the_heun_candidate_once(bundle):
    """One UNet eval a step, and one more at the first step (the Heun candidate)."""
    d = bundle["d"]
    calls = []
    model = bundle["model"]
    real = model.apply_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model, "apply_model", lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
        with torch.inference_mode():
            plms_sample(model, *(t(d[k]) for k in ("x_T", "cond", "uncond", "inpaint", "mask")), num_steps=STEPS)
    assert calls == [2 * B] * (STEPS + 1)


GUIDED = {"plain": (False, 0.0), "scaling": (True, 0.0), "grad": (False, 0.5), "both": (True, 0.5)}


@pytest.mark.parametrize("case", sorted(GUIDED))
def test_ddim_sample_guided_matches_jax(bundle, case):
    """Guided CFG DDIM with ``id_dir_scaling`` on and off and ``grad_weight`` 0
    and 0.5 (the ID gradient through the decode and ArcFace): z_0 and the
    trajectory within 1e-4 of JAX's. The model's parameters gain no gradient."""
    from vface_tpu.samplers.guided import ddim_sample_guided as jax_guided

    scaling, gw = GUIDED[case]
    d = bundle["d"]
    args = [d[k] for k in ("x_T", "cond", "uncond", "inpaint", "mask", "emb", "keep")]
    kw = dict(num_steps=STEPS, cfg_scale=3.0, id_dir_scaling=scaling, grad_weight=gw)
    wz, wtraj = jax_guided(bundle["jm"], bundle["params"], *map(jnp.asarray, args), **kw)
    model = bundle["model"]
    z, traj = ddim_sample_guided(model, *map(t, args), **kw)
    close(z, np.asarray(wz), atol=1e-4)
    close(traj, np.asarray(wtraj), atol=1e-4)
    assert all(p.grad is None and p.requires_grad for p in model.parameters())
    assert not z.requires_grad


def test_guidance_moves_the_sample(bundle):
    """Each mechanism changes z_0 against plain DDIM on the same inputs (neither is a no-op)."""
    d = bundle["d"]
    args = [t(d[k]) for k in ("x_T", "cond", "uncond", "inpaint", "mask", "emb", "keep")]
    z = {case: ddim_sample_guided(bundle["model"], *args, num_steps=2, id_dir_scaling=s, grad_weight=g)[0]
         for case, (s, g) in GUIDED.items() if case != "both"}
    assert float((z["scaling"] - z["plain"]).abs().max()) > 1e-4
    assert float((z["grad"] - z["plain"]).abs().max()) > 1e-4
