"""CLIP ViT-B/32 text encoder (reference modules/CLIPWrapper.py), PyTorch.

Port of ``objcavit_tpu/models/clip_text.py``: token embedding (vocab 49408)
plus a learned positional embedding (context 77), pre-LN transformer blocks
(width 512, 8 heads, 12 layers at full width) with QuickGELU, a causal mask
of -inf and an fp32 softmax, a final LayerNorm, then the EOT token's
activation (the argmax of the token ids, CLIP's convention) through the
text projection. Width, heads and layers are constructor arguments, as in
JAX, so tests can run it narrow. Module names are the JAX package's
(``block{i}.attn.in_proj``, ``ln_final``, ...), so
``utils/convert.py::clip_text_state_dict_from_params`` maps its params one
to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

CLIP_VOCAB = 49408
CLIP_CONTEXT = 77
CLIP_WIDTH = 512
CLIP_HEADS = 8
CLIP_LAYERS = 12


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, s, width = x.shape
        d = width // self.heads
        q, k, v = (t.reshape(b, s, self.heads, d) for t in self.in_proj(x).chunk(3, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
        scores = scores.masked_fill(~causal, float("-inf"))
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, width)
        return self.out_proj(out)


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = CLIP_VOCAB, context_length: int = CLIP_CONTEXT,
                 width: int = CLIP_WIDTH, heads: int = CLIP_HEADS, layers: int = CLIP_LAYERS,
                 embed_dim: int = 512):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        for i in range(layers):
            self.add_module(f"block{i}", CLIPBlock(width, heads))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "CLIPTextEncoder":
        """Random weights from ``generator``, with the JAX package's
        distributions where it names them: positional embedding N(0, 0.01),
        text projection N(0, width^-1/2); embeddings N(0, 1), linears
        U(+-1/sqrt(fan_in)) (PyTorch's), LayerNorms at identity."""
        width = self.positional_embedding.shape[1]
        self.token_embedding.weight.normal_(generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, width ** -0.5, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, 77) int (BPE ids, 0-padded after EOT) -> (B, embed_dim)
        text features, not L2-normalised (the reference reads raw
        encode_text outputs)."""
        x = self.token_embedding(tokens) + self.positional_embedding.to(
            self.token_embedding.weight.dtype)
        s = tokens.shape[1]
        causal = torch.ones((s, s), dtype=torch.bool, device=tokens.device).tril()
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # the EOT token has the highest id
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)

