"""The CLIP text side of the port against the JAX package's: the tokenizer, the
text tower and encoder, ``clip_similarity_logits`` and the legacy 1024-d image embedder.

The tokenizer runs on a synthetic vocabulary and merges, built as
``tests/test_reference_parity.py::test_clip_tokenizer_parity`` builds them
(the byte alphabet and its ``</w>`` forms, a few merges, BOS / EOS last): no
vocabulary file is in the repo. The port's word split uses the standard
``re`` module with the letter and number classes enumerated from
``unicodedata``, where JAX's uses the ``regex`` package's ``\\p{L}`` /
``\\p{N}``: the two are held equal on every code point that this Python's
Unicode database assigns, and on text in several scripts. The models run at
``CLIPTextConfig.tiny()`` / ``CLIPVisionConfig.tiny()`` on seeded numpy
weights, fp32 on the CPU, within 1e-5.
"""

import json
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_flax_params, t
from vface_tpu.models import clip as JC
from vface_tpu.models import clip_tokenizer as JT
from vface_torch.models import clip as TC
from vface_torch.models import clip_tokenizer as TT
from vface_torch.utils.convert import flax_tree_to_state_dict

TEXTS = [
    "hello world",
    "Hello,  WORLD!!",
    "the cat's hello, we'll SEE; it'd be ok",
    "a1 the\tworld\n 2024",
    "héllo Ça va? naïve café Ærøskøbing",       # accented Latin
    "Привет мир, Ελληνικά, עברית, العربية ٣٤",   # Cyrillic, Greek, Hebrew, Arabic with its digits
    "東京タワー 中文 한국어 ひらがな",                  # CJK (spaced out), kana, Hangul
    "x² + y³ = ½ ⅓ Ⅻ ①",                        # superscripts, fractions, Roman numerals, circled digits
    "ǅ ͅ ᾳ 𝔘𝔫𝔦 🙂🙂 ...",                          # titlecase, the ypogegrammeni, math letters, emoji
    "<|startoftext|>a photo of a face<|endoftext|>",
    "",
]


def _vocab():
    alpha = list(JT.byte_alphabet().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"), ("hell", "o</w>"), ("w", "o"), ("r", "l"),
              ("d", "</w>"), ("wo", "rl"), ("worl", "d</w>"), ("'", "s</w>"), ("s", "</w>"), ("a", "</w>"),
              ("t", "h"), ("th", "e</w>"), ("e", "</w>"), ("1", "</w>"), ("!", "</w>")]
    vocab = {}
    for tok in alpha + [a + "</w>" for a in alpha]:
        vocab.setdefault(tok, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab[JT.BOS] = len(vocab)
    vocab[JT.EOS] = len(vocab)
    return vocab, merges


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    vocab, merges = _vocab()
    vp, mp = d / "vocab.json", d / "merges.txt"
    vp.write_text(json.dumps(vocab))
    mp.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return JT.CLIPBPETokenizer.from_files(str(vp), str(mp)), TT.CLIPBPETokenizer.from_files(str(vp), str(mp))


def test_word_split_classes_match_regex_on_every_assigned_code_point():
    """Each code point assigned in this Python's Unicode database, alone and in
    four contexts, splits as JAX's ``regex`` pattern splits it."""
    port, ref = TT.word_pattern(), JT._WORD_PATTERN
    bad = []
    for cp in range(0x110000):
        c = chr(cp)
        if unicodedata.category(c) in ("Cn", "Cs"):
            continue
        for text in (c, c + c, "a" + c, c + "1", "'" + c):
            if port.findall(text) != ref.findall(text):
                bad.append(hex(cp))
                break
    assert bad == []


def test_tokenizer_ids_padding_and_masks_match_jax(tokenizers):
    jt, tt = tokenizers
    assert TT.byte_alphabet() == JT.byte_alphabet()
    for text in TEXTS:
        assert TT.clean_text(text) == JT.clean_text(text)
        assert tt.tokenize(text) == jt.tokenize(text), text
    for kw in ({}, {"max_length": 8}, {"max_length": 24, "padding": "max_length"}):
        got, want = tt(TEXTS, **kw), jt(TEXTS, **kw)
        for k in ("input_ids", "attention_mask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert any(i > 255 for row in tt(TEXTS)["input_ids"] for i in row[1:])  # a merge is taken
    np.testing.assert_array_equal(tt("hello")["input_ids"], jt("hello")["input_ids"])


def _text_pair(seed=5):
    cfg = JC.CLIPTextConfig.tiny()
    jenc = JC.CLIPTextEncoder(cfg)
    params = seeded_flax_params(jenc, jnp.zeros((1, 4), jnp.int32), seed=seed)
    tenc = TC.CLIPTextEncoder(TC.CLIPTextConfig.tiny())
    tenc.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    return jenc, params, tenc


def test_text_encoder_matches_jax_with_causal_and_pad_masks():
    """Rows of different lengths, EOS (63) inside and as padding: the hidden
    states, the pooled first-EOS state and the projection, with and without
    the pad mask."""
    jenc, params, tenc = _text_pair()
    r = np.random.default_rng(0)
    ids = r.integers(0, 62, size=(3, 12)).astype(np.int32)
    lengths = [7, 12, 4]
    for i, n in enumerate(lengths):
        ids[i, n - 1:] = 63
    ids[1, 11] = 63
    mask = (np.arange(12)[None] < np.array(lengths)[:, None]).astype(np.int32)
    for pm in (mask, None):
        want = jenc.apply({"params": params}, ids, pad_mask=pm)
        with torch.no_grad():
            got = tenc(t(ids), pad_mask=None if pm is None else t(pm))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            close(g, w, atol=1e-5)
    # the pad mask matters, and pooling takes the first EOS
    with torch.no_grad():
        h_masked, pooled, _ = tenc(t(ids), pad_mask=t(mask))
        h_plain = tenc(t(ids))[0]
    assert float((h_masked - h_plain).abs().max()) > 1e-3
    close(pooled[0], h_masked[0, lengths[0] - 1], atol=0.0)


def test_tokenizer_feeds_the_tower_as_in_jax(tokenizers):
    """Text -> ids -> the tiny tower (ids reduced into its 64-token vocabulary,
    EOS kept as 63): the port's chain against JAX's."""
    jt, tt = tokenizers
    jenc, params, tenc = _text_pair(seed=6)
    batch = tt(["hello world", "naïve café 中文", "the cat's"], max_length=16)
    want_batch = jt(["hello world", "naïve café 中文", "the cat's"], max_length=16)
    np.testing.assert_array_equal(batch["input_ids"], want_batch["input_ids"])
    ids = np.where(batch["input_ids"] == tt.eos_id, 63, batch["input_ids"] % 63).astype(np.int32)
    want = jenc.apply({"params": params}, ids, pad_mask=want_batch["attention_mask"])
    with torch.no_grad():
        got = tenc(t(ids), pad_mask=t(batch["attention_mask"]))
    for g, w in zip(got, want):
        close(g, w, atol=1e-5)


def test_similarity_logits_match_jax():
    r = np.random.default_rng(1)
    text, image = r.normal(size=(3, 24)).astype(np.float32), r.normal(size=(5, 24)).astype(np.float32)
    want = JC.clip_similarity_logits(text, image, 2.6592)
    got = TC.clip_similarity_logits(t(text), t(image), 2.6592)
    assert tuple(got.shape) == (5, 3)
    close(got, want, atol=1e-5)


def test_legacy_image_embedder_matches_jax():
    cfg = JC.CLIPVisionConfig.tiny()
    jm = JC.CLIPImageEmbedderLegacy(cfg)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = seeded_flax_params(jm, jnp.zeros((1, 32, 32, 3)), seed=7)
    tm = TC.CLIPImageEmbedderLegacy(TC.CLIPVisionConfig.tiny())
    tm.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    with torch.no_grad():
        got = tm(t(x))
    assert tuple(got.shape) == (2, 1, 64)
    close(got, jm.apply({"params": params}, x), atol=1e-5)
