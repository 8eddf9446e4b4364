"""The CLIP text tower (ViT-L/14 text transformer) and its tokenizer, plain
PyTorch.

Counterpart of the text half of the JAX package's `models/clip.py`: token
and positional embeddings, pre-LN causal blocks with QuickGELU, a final
LayerNorm, and the output at the end-of-text position projected by
`text_projection`. Parameter names are openai CLIP's, so its state_dict
(text side) loads as it is.

As in the JAX tower, the embeddings and the residual stream stay float32
while each block's LayerNorm output, projections and MLP run in the
tower's dtype (float16 by default); scores and softmax are float32.

Tokenizers: `BpeTokenizer`, the CLIP byte-pair tokenizer read from the
openai vocab file (`bpe_simple_vocab_16e6.txt.gz`, not in the
repository), and `HashTokenizer`, the deterministic stand-in used when no
vocab file is given. Both give the JAX package's ids.
"""

from __future__ import annotations

import gzip
import hashlib
import math
import os
import re
import unicodedata
import warnings
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from transformer_latent_diffusion_tpu_torch.models.blocks import dense, layer_norm

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """openai CLIP's attention parameters: fused in_proj and out_proj."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ClipTextBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _Mlp(width)

    def forward(self, x, mask):
        dt = self.dtype
        h = layer_norm(x, self.ln_1, dt)
        b, n, d = h.shape
        dh = d // self.heads
        qkv = dense(h, self.attn.in_proj_weight, self.attn.in_proj_bias, dt)
        q, k, v = (t.reshape(b, n, self.heads, dh).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        attn = (p @ v).transpose(1, 2).reshape(b, n, d)
        out = self.attn.out_proj
        x = x + dense(attn, out.weight, out.bias, dt)

        h = layer_norm(x, self.ln_2, dt)
        h = _quick_gelu(dense(h, self.mlp.c_fc.weight, self.mlp.c_fc.bias, dt))
        return x + dense(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias, dt)


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ClipTextBlock(width, heads, dtype) for _ in range(layers))


class ClipTextModel(nn.Module):
    """Causal text transformer with end-of-text pooling and projection."""

    def __init__(self, vocab_size: int = VOCAB_SIZE,
                 context_length: int = CONTEXT_LENGTH, width: int = 768,
                 heads: int = 12, layers: int = 12, embed_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers, dtype)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32) -> "ClipTextModel":
        return cls(width=cfg.width, heads=cfg.heads, layers=cfg.layers,
                   embed_dim=cfg.embed_dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, 77) int -> pooled text embedding (B, embed_dim) in the
        tower's dtype."""
        b, n = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[None, :n]
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=tokens.device).tril()[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = layer_norm(x, self.ln_final, self.dtype)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection.to(pooled.dtype)

    @torch.no_grad()
    def encode_text(self, texts: Union[str, Sequence[str]],
                    tokenizer=None) -> torch.Tensor:
        """Prompt(s) -> pooled embeddings (B, embed_dim), on the tower's
        device. Counterpart of the JAX package's `FlaxClip.encode_text`."""
        ids = tokenize(texts, tokenizer)
        device = self.token_embedding.weight.device
        return self(torch.as_tensor(ids, dtype=torch.int64, device=device))


# ----------------------------- tokenizer -----------------------------------


def _basic_clean(text: str) -> str:
    return " ".join(text.lower().strip().split())


class HashTokenizer:
    """Deterministic stand-in tokenizer (no vocab file needed): maps
    whitespace-separated words to stable ids in [1, 49405]. Not the real
    CLIP BPE, so embeddings only mean something with trained weights when
    `BpeTokenizer` reads the vocab file."""

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _basic_clean(text).split(" "):
            if not word:
                continue
            h = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4],
                               "little")
            ids.append(1 + h % (SOT_TOKEN - 1))
        return ids


# the JAX tokenizer's pattern (the `regex` package, IGNORECASE):
#   <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# Python's `re` has no \p{L} or \p{N} (`[^\W\d_]` and `\d` are other
# classes: they take or miss characters such as "½" or "Ⅻ"), so the
# literal alternatives go through `re` and the three classes are read from
# `unicodedata.category`, scanned as the pattern's alternatives would be.
_LITERALS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
                       re.IGNORECASE)
# U+0345 (Mn) folds to a letter under IGNORECASE, so the negated class
# refuses it, though \p{L} does not take it either: no alternative matches
_UNMATCHED = "\u0345"


def _char_class(c: str) -> str:
    """"L" (a letter), "N" (a number), "S" (whitespace, or a character no
    alternative takes) or "O" (the rest: the pattern's last class)."""
    if c.isspace() or c in _UNMATCHED:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _pre_tokenize(text: str) -> List[str]:
    """`regex.findall` of the JAX tokenizer's pattern over `text`."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERALS.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        kind = _char_class(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # [\p{L}]+ and [^\s\p{L}\p{N}]+ are greedy runs
            while j < n and _char_class(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _byte_encoder() -> Tuple[List[int], Dict[int, str]]:
    """CLIP's reversible byte -> printable character map (the bytes in
    their vocabulary order, and the map)."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return bs, dict(zip(bs, [chr(c) for c in cs]))


class BpeTokenizer:
    """The CLIP byte-pair tokenizer, loaded from the standard
    `bpe_simple_vocab_16e6.txt.gz` vocab file. Counterpart of the JAX
    package's `BpeTokenizer`, with the standard library only: the
    character classes come from the interpreter's `unicodedata`, so a
    character that a newer Unicode database assigns (the `regex` package
    may carry one) can split differently."""

    def __init__(self, vocab_path: str):
        bs, self.byte_encoder = _byte_encoder()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = sorted({self.byte_encoder[b] for b in bs})
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(merge) for merge in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _pre_tokenize(_basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


def make_tokenizer(vocab_path=None, real_weights: bool = False):
    """The tokenizer that the JAX package's `FlaxClip.create` picks: the BPE
    when `vocab_path` names a file, else `HashTokenizer`, with its loud
    warning when trained tower weights come without a vocab."""
    import os

    if vocab_path and os.path.exists(vocab_path):
        return BpeTokenizer(vocab_path)
    if real_weights:
        warnings.warn(
            "CLIP weights were provided but no BPE vocab_path: falling back "
            "to the HashTokenizer stub, whose token ids DO NOT match the "
            "trained vocabulary — text embeddings will be garbage. Pass "
            "ClipConfig(vocab_path=...) pointing at the openai CLIP "
            "bpe_simple_vocab_16e6.txt.gz.", stacklevel=2)
    return HashTokenizer()


def tokenize(texts: Union[str, Sequence[str]], tokenizer=None,
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = True) -> np.ndarray:
    """`clip.tokenize` equivalent: (B, 77) int32 with SOT/EOT and padding."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or HashTokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tokenizer.encode(text) + [EOT_TOKEN]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input too long for context {context_length}")
            ids = ids[:context_length]
            ids[-1] = EOT_TOKEN
        out[i, : len(ids)] = ids
    return out
