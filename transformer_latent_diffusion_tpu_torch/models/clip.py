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

Tokenizer: `HashTokenizer`, the deterministic stand-in that gives the
same ids as the JAX package's. The real CLIP BPE waits for its vocab
file (ROADMAP).
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence, Union

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
    CLIP BPE, so embeddings only mean something with trained weights once
    the BPE is ported with its vocab file."""

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _basic_clean(text).split(" "):
            if not word:
                continue
            h = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4],
                               "little")
            ids.append(1 + h % (SOT_TOKEN - 1))
        return ids


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
