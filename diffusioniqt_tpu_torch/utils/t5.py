"""Text embeddings for the text-conditioned video U-Net (counterpart of
``diffusioniqt_tpu/utils/t5.py``; reference ``t5.py:27-119``), a copy: the
port imports nothing of the JAX package.

Three tiers, as in the JAX module:

  * :func:`t5_encode_text` with pretrained weights, when Hugging Face
    ``transformers`` is installed and the weights are cached;
  * :func:`t5_encode_text` with ``allow_random_init=True``: the genuine
    ``T5EncoderModel`` forward with deterministic random weights
    (``torch.manual_seed(0)``) and a sentencepiece-free whitespace
    tokenizer, so the path runs offline;
  * :func:`hash_text_encode`: deterministic pseudo-embeddings from word
    hashes, numpy and ``hashlib`` only, bit for bit the JAX function's.

``transformers`` is imported only inside the functions that need it; where
it is missing they raise an error that names it. The 3D IQT path never
uses text.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np
import torch

DEFAULT_T5_NAME = "google/t5-v1_1-base"

T5_CONFIGS = {
    "t5-small": 512,
    "t5-base": 768,
    "t5-large": 1024,
    "google/t5-v1_1-small": 512,
    "google/t5-v1_1-base": 768,
    "google/t5-v1_1-large": 1024,
    "google/t5-v1_1-xl": 2048,
    "google/t5-v1_1-xxl": 4096,
}

_CACHE = {}


def get_encoded_dim(name: str = DEFAULT_T5_NAME) -> int:
    """Embedding width of a T5 variant (768 for a name not in the table)."""
    return T5_CONFIGS.get(name, 768)


class _WhitespaceTokenizer:
    """Sentencepiece-free stand-in tokenizer for the random-init encoder:
    each word hashes to a stable id in ``[2, vocab_size)``, then T5's
    ``</s>`` = 1; pad is 0."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def __call__(self, texts, return_tensors="pt", padding="longest",
                 max_length: int = 256, truncation: bool = True):
        from types import SimpleNamespace

        seqs = []
        for text in texts:
            toks = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                    % (self.vocab_size - 2) + 2 for w in text.split()]
            if truncation:
                toks = toks[: max_length - 1]
            seqs.append(toks + [1])  # </s>
        length = max(len(s) for s in seqs)
        input_ids = torch.zeros(len(seqs), length, dtype=torch.long)
        mask = torch.zeros(len(seqs), length, dtype=torch.long)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = torch.tensor(s)
            mask[i, : len(s)] = 1
        return SimpleNamespace(input_ids=input_ids, attention_mask=mask)


def _import_transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "t5_encode_text needs the Hugging Face 'transformers' package, which is not "
            "installed; use hash_text_encode for weights-free embeddings") from e
    return transformers


def _random_init_encoder(name: str):
    """A randomly initialised HF ``T5EncoderModel`` (2 layers, 4 heads,
    vocabulary 512, ``d_model`` the variant's width) and the stand-in
    tokenizer: the JAX module's config, drawn under ``torch.manual_seed(0)``."""
    transformers = _import_transformers()
    torch.manual_seed(0)
    config = transformers.T5Config(
        vocab_size=512, d_model=get_encoded_dim(name), d_kv=32, d_ff=128,
        num_layers=2, num_heads=4, decoder_start_token_id=0)
    model = transformers.T5EncoderModel(config)
    model.eval()
    return model, _WhitespaceTokenizer(config.vocab_size)


def _get_model_and_tokenizer(name: str, allow_random_init: bool = False):
    # a random-init encoder is cached under (name, True) only, so a later
    # call without allow_random_init never receives random weights
    for key in ((name, False), (name, True)) if allow_random_init else ((name, False),):
        if key in _CACHE:
            return _CACHE[key]
    transformers = _import_transformers()
    random_init = False
    try:
        tokenizer = transformers.T5Tokenizer.from_pretrained(name)
        model = transformers.T5EncoderModel.from_pretrained(name)
        model.eval()
    except Exception as e:  # no cached weights and no network
        if not allow_random_init:
            raise RuntimeError(
                f"could not load T5 '{name}' (no cached weights): {e}. Pass "
                "allow_random_init=True for a randomly initialised encoder, or use "
                "hash_text_encode.") from e
        model, tokenizer = _random_init_encoder(name)
        random_init = True
    _CACHE[(name, random_init)] = (model, tokenizer)
    return _CACHE[(name, random_init)]


def t5_encode_text(texts: List[str], name: str = DEFAULT_T5_NAME, max_length: int = 256,
                   return_attn_mask: bool = False, allow_random_init: bool = False):
    """Tokenize and encode ``texts`` on the CPU: fp32 embeddings ``(B, L,
    dim)`` with the padded positions zeroed (reference t5.py:107-119), and
    with ``return_attn_mask`` the bool mask ``(B, L)``."""
    model, tokenizer = _get_model_and_tokenizer(name, allow_random_init=allow_random_init)
    enc = tokenizer(texts, return_tensors="pt", padding="longest", max_length=max_length,
                    truncation=True)
    with torch.no_grad():
        out = model(input_ids=enc.input_ids, attention_mask=enc.attention_mask)
    mask = enc.attention_mask.bool()
    emb = (out.last_hidden_state * mask[..., None]).float()
    return (emb, mask) if return_attn_mask else emb


def hash_text_encode(texts: List[str], dim: int = 768, max_length: int = 16,
                     return_attn_mask: bool = False, device: Optional[torch.device] = None):
    """Deterministic pseudo-embeddings, a weights-free stand-in with the
    interface of :func:`t5_encode_text`: word ``j`` of text ``i`` (at most
    ``max_length`` words) is a standard normal vector drawn by numpy's
    ``default_rng`` seeded with the first 8 bytes of the word's SHA-256;
    the rest is zeros and masked off. fp32 ``(B, max_length, dim)`` (and
    the bool mask ``(B, max_length)``) on ``device`` (default the CPU)."""
    emb = np.zeros((len(texts), max_length, dim), np.float32)
    mask = np.zeros((len(texts), max_length), bool)
    for i, text in enumerate(texts):
        for j, word in enumerate(text.split()[:max_length]):
            digest = hashlib.sha256(word.encode()).digest()
            rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
            emb[i, j] = rng.standard_normal(dim).astype(np.float32)
            mask[i, j] = True
    emb_t = torch.from_numpy(emb).to(device or "cpu")
    if return_attn_mask:
        return emb_t, torch.from_numpy(mask).to(device or "cpu")
    return emb_t
