"""The port's CLIP byte-pair tokenizer against the JAX package's, on a
synthetic gzip vocab (the real one is not in the repository) with merges
for accented letters, digits and apostrophes: the same ids for every
string, the same (B, 77) token arrays, and the same pooled text
embeddings through both towers; and `DiffusionTransformer` with
`ClipConfig(vocab_path=...)` building and generating on the CPU. The JAX
tokenizer reads its pattern with the `regex` package; the port's uses
the standard library only."""

import gzip

import jax
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.models.clip import BpeTokenizer as JaxBpe
from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.clip import tokenize as jax_tokenize
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.clip import (
    BpeTokenizer,
    ClipTextModel,
    HashTokenizer,
    make_tokenizer,
    tokenize,
)
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    DiffusionTransformer,
)

torch.set_num_threads(2)

# merges over CLIP's byte alphabet: "Ã ©" is é (UTF-8 C3 A9), "Ã ¼" ü,
# "Ã ¶" ö, "Ã ¯" ï; "Â ½" is ½ (C2 BD)
MERGES = """c a
ca t</w>
ca f
caf Ã©</w>
Ã ©
Ã ©</w>
Ã ¼
Ã ¶
Ã ¯
Â ½</w>
1 2
12 3</w>
2 0
20 2
202 6</w>
' s</w>
l l</w>
' ll</w>
' t</w>
w e</w>
i t</w>
t h
th e</w>
o n</w>
a n
an d</w>
d o
do g</w>
! !
!! !</w>
. .
.. .</w>
n Ã¯
c Ã¶
d Ã©</w>
"""

STRINGS = [
    "Ünïcödé café", "½ ² Ⅻ ٣", "it's we'll", "東京タワーと猫", "a cat 🙂🐈 on the moon",
    "!!! ... ?!?, --- (cat)", "A CaT On ThE MaT and a DOG", "route 123 in 2026, 12.5%",
    "it'S WE'LL don't", "<|startoftext|>cat<|endoftext|>", "",
    " ".join(["a cat on the mat and the dog's café"] * 12),
]
IDS = ["accents", "numbers", "apostrophes", "cjk", "emoji", "punctuation",
       "mixed_case", "digits", "apostrophes_upper", "specials", "empty", "long"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + MERGES)
    return str(path)


@pytest.mark.parametrize("text", STRINGS, ids=IDS)
def test_encode_matches_jax(vocab, text):
    """The same ids, to the id, and merges taken where the vocab has them."""
    want = JaxBpe(vocab).encode(text)
    got = BpeTokenizer(vocab).encode(text)
    assert got == want


def test_merges_apply(vocab):
    """The synthetic merges are reached: a whole word is one token."""
    tok = BpeTokenizer(vocab)
    assert len(tok.encode("café")) == 1 and len(tok.encode("cat")) == 1
    assert tok.encode("it's")[-1] == tok.encoder["'s</w>"]
    assert tok.encode("½") == [tok.encoder["Â½</w>"]]


def test_tokenize_matches_jax_and_truncates(vocab):
    """(B, 77) int32 with SOT/EOT and padding; the long prompt is cut to 77
    with EOT last, on both sides."""
    want = jax_tokenize(STRINGS, JaxBpe(vocab))
    got = tokenize(STRINGS, BpeTokenizer(vocab))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(STRINGS), 77) and got.dtype == np.int32
    assert len(BpeTokenizer(vocab).encode(STRINGS[-1])) > 77 and got[-1, -1] == 49407


def test_encode_text_with_the_bpe_matches_jax(vocab):
    """Pooled embeddings of the tiny float32 towers, each with its own
    package's BPE: 1e-5 of the scale, the bound of
    tests/test_torch_port_towers.py (summation order)."""
    clip = FlaxClip.create(width=64, heads=2, layers=2, embed_dim=64,
                           vocab_path=vocab)
    assert isinstance(clip.tokenizer, JaxBpe)
    want = np.asarray(clip.encode_text(STRINGS), np.float32)
    port = ClipTextModel(width=64, heads=2, layers=2, embed_dim=64)
    sd = convert.clip_text_state_dict(jax.tree.map(np.asarray, clip.params))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = port.eval().encode_text(STRINGS, BpeTokenizer(vocab)).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_tokenizer_choice_matches_flax_clip(vocab, tmp_path):
    """The BPE when the vocab file exists, else the hash stand-in; trained
    weights without a vocab warn, as `FlaxClip.create` does."""
    assert isinstance(make_tokenizer(vocab), BpeTokenizer)
    assert isinstance(make_tokenizer(str(tmp_path / "missing.gz")), HashTokenizer)
    assert isinstance(make_tokenizer(None), HashTokenizer)
    with pytest.warns(UserWarning, match="no BPE vocab_path"):
        assert isinstance(make_tokenizer(None, real_weights=True), HashTokenizer)


def test_vocab_path_builds_and_generates(vocab, tmp_path):
    """`ClipConfig(vocab_path=...)` raised NotImplementedError before the
    BPE was ported; the transformer now builds with the BPE, its labels
    are the tower's on the BPE's ids, and it generates on the CPU. Tower
    weights from a file without a vocab warn."""
    cfg = pc.LTDConfig(
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2, vocab_path=vocab))
    tr = DiffusionTransformer(cfg, device="cpu")
    assert isinstance(tr.tokenizer, BpeTokenizer)
    labels, _ = tr._encode_prompts(["a café"], None, 1)
    want = tr.clip_model.encode_text(["a café"], BpeTokenizer(vocab))
    torch.testing.assert_close(labels, want, atol=0, rtol=0)
    out = tr.generate_array_from_text("a café", n_iter=2, sampler="ddim")
    assert out.shape == (1, 32, 32, 3) and out.dtype == np.uint8

    weights = tmp_path / "clip.pth"
    torch.save(tr.clip_model.state_dict(), weights)
    no_vocab = pc.ClipConfig(width=64, heads=2, layers=2, weights_path=str(weights))
    with pytest.warns(UserWarning, match="no BPE vocab_path"):
        tr = DiffusionTransformer(pc.LTDConfig(vae_cfg=cfg.vae_cfg, clip_cfg=no_vocab),
                                  device="cpu")
    assert isinstance(tr.tokenizer, HashTokenizer)
