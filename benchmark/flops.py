"""Operations and bytes of the work the cells do, from shapes alone.

The counts follow the published networks, as the configuration files give
their sizes, and not what the program chooses to run: a product that the
program skips is still counted, so ``mfu`` bounds any claim. A multiply-add
is two operations; convolutions, dense layers and both attention products
are counted, as ``torch.utils.flop_counter.FlopCounterMode`` counts them;
normalisations, activations, the FSAI FFTs and other elementwise work are
not. ``PEAKS`` is the published table of one H100 SXM (dense, 700 W).
"""

from __future__ import annotations

PEAKS = {
    "bf16_flops": 989e12,  # tensor cores, dense
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes": 3.35e12,  # bytes a second
}


def least_seconds(flops: float, nbytes: float, peak: str = "bf16_flops") -> float:
    """The least time the chip could take: operations at the peak or bytes at the bandwidth."""
    return max(flops / PEAKS[peak], nbytes / PEAKS["hbm_bytes"])


def conv(b: int, h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    """A k x k convolution with an (h, w) output."""
    return 2.0 * b * h * w * cin * cout * k * k


def dense(m: int, cin: int, cout: int) -> float:
    return 2.0 * m * cin * cout


def attn1(b: int, n: int, c: int) -> float:
    """A self-attention site over n tokens of width c: q, k, v, out and both products."""
    return 4 * dense(b * n, c, c) + 4.0 * b * n * n * c


def attn1_work(b: int, n: int, c: int, act_bytes: int = 2, weight_bytes: int = 4):
    """(operations, bytes) of one self-attention site: its input and output read
    and written once, its four weights read once as they are stored."""
    return attn1(b, n, c), 2 * b * n * c * act_bytes + 4 * c * c * weight_bytes


def feed_forward(m: int, c: int, inner: int) -> float:
    """GEGLU: the projection to 2 * inner and the product back to c."""
    return dense(m, c, 2 * inner) + dense(m, inner, c)


def ff_work(m: int, c: int, inner: int, act_bytes: int = 2, weight_bytes: int = 4):
    """(operations, bytes) of one GEGLU feed-forward over m rows."""
    return feed_forward(m, c, inner), 2 * m * c * act_bytes + (3 * c * inner + 2 * inner + c) * weight_bytes


def cross_attention(b: int, n: int, c: int, ctx_dim: int, ctx_tokens: int) -> float:
    """attn2: with a one-token context the softmax is 1, so only v and out of that token run."""
    if ctx_tokens == 1:
        return dense(b, ctx_dim, c) + dense(b, c, c)
    return (2 * dense(b * n, c, c) + 2 * dense(b * ctx_tokens, ctx_dim, c)
            + 4.0 * b * n * ctx_tokens * c)


def transformer(b: int, n: int, c: int, ctx_dim: int, ctx_tokens: int) -> float:
    """A SpatialTransformer of depth 1: proj_in, attn1, attn2, the feed-forward, proj_out."""
    return (2 * dense(b * n, c, c) + attn1(b, n, c) + cross_attention(b, n, c, ctx_dim, ctx_tokens)
            + feed_forward(b * n, c, 4 * c))


def unet_resblock(b: int, h: int, w: int, cin: int, cout: int, emb: int) -> float:
    skip = conv(b, h, w, cin, cout, 1) if cin != cout else 0.0
    return conv(b, h, w, cin, cout) + dense(b, emb, cout) + conv(b, h, w, cout, cout) + skip


def unet_eval(cfg: dict, b: int, h: int, w: int, ctx_tokens: int = 1) -> float:
    """One UNet forward on b rows of an (h, w) latent; ``cfg`` the configuration's "unet"."""
    mc, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    attn_ds, ctx = cfg["attention_resolutions"], cfg["context_dim"]
    emb = 4 * mc
    total = dense(b, mc, emb) + dense(b, emb, emb) + conv(b, h, w, cfg["in_channels"], mc)
    chans, ch, ds = [mc], mc, 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            total += unet_resblock(b, h, w, ch, mc * m, emb)
            ch = mc * m
            if ds in attn_ds:
                total += transformer(b, h * w, ch, ctx, ctx_tokens)
            chans.append(ch)
        if level != len(mult) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            total += conv(b, h, w, ch, ch)
            chans.append(ch)
            ds *= 2
    total += 2 * unet_resblock(b, h, w, ch, ch, emb) + transformer(b, h * w, ch, ctx, ctx_tokens)
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            total += unet_resblock(b, h, w, ch + chans.pop(), mc * mult[level], emb)
            ch = mc * mult[level]
            if ds in attn_ds:
                total += transformer(b, h * w, ch, ctx, ctx_tokens)
            if level != 0 and i == nrb:
                h, w = 2 * h, 2 * w
                total += conv(b, h, w, ch, ch)
                ds //= 2
    return total + conv(b, h, w, ch, cfg["out_channels"])


def _vae_resblock(b, h, w, cin, cout) -> float:
    return conv(b, h, w, cin, cout) + conv(b, h, w, cout, cout) + (conv(b, h, w, cin, cout, 1) if cin != cout else 0.0)


def _vae_mid(b, h, w, c) -> float:
    n = h * w
    return 2 * _vae_resblock(b, h, w, c, c) + 4 * dense(b * n, c, c) + 4.0 * b * n * n * c


def vae_encode(cfg: dict, b: int, height: int, width: int) -> float:
    """The encoder and quant_conv on b images of (height, width); ``cfg`` the configuration's "vae"."""
    ch0, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    h, w = height, width
    total = conv(b, h, w, 3, ch0)
    ch = ch0
    for i, m in enumerate(mult):
        for _ in range(nrb):
            total += _vae_resblock(b, h, w, ch, ch0 * m)
            ch = ch0 * m
        if i != len(mult) - 1:
            h, w = h // 2, w // 2
            total += conv(b, h, w, ch, ch)
    moments = 2 * cfg["z_channels"]
    return total + _vae_mid(b, h, w, ch) + conv(b, h, w, ch, moments) + conv(b, h, w, moments, 2 * cfg["embed_dim"], 1)


def vae_decode(cfg: dict, b: int, h: int, w: int) -> float:
    """post_quant_conv and the decoder on b latents of (h, w)."""
    ch0, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    ch = ch0 * mult[-1]
    total = conv(b, h, w, cfg["embed_dim"], cfg["z_channels"], 1) + conv(b, h, w, cfg["z_channels"], ch)
    total += _vae_mid(b, h, w, ch)
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            total += _vae_resblock(b, h, w, ch, ch0 * mult[i])
            ch = ch0 * mult[i]
        if i != 0:
            h, w = 2 * h, 2 * w
            total += conv(b, h, w, ch, ch)
    return total + conv(b, h, w, ch, 3)
