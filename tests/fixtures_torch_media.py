"""Inputs and cross gates of the vlm and audio families' port tests.

Free of JAX, so the card-only tests (``test_torch_cuda.py``) share them
with the tests that hold the port against the reference.  The vlm's cross
blocks' gates initialise to zero (``tanh(0) = 0``: each cross block adds
nothing), so every vlm case sets them to ``gate_values`` first.
"""
import numpy as np
import torch


def gate_values(cfg):
    """The non-zero gates every vlm case sets, per cross block g:
    (gate_attn, gate_mlp)."""
    g = np.arange(cfg.n_layers // cfg.cross_attn_period, dtype=np.float32)
    return 0.5 + 0.1 * g, -0.4 - 0.1 * g


def open_gates(model):
    """The port's model with its cross blocks' gates set to
    ``gate_values`` (in place; other families' models as they are)."""
    if model.cfg.family == "vlm":
        with torch.no_grad():
            for blk, a, m in zip(model.cross, *gate_values(model.cfg)):
                blk.gate_attn.fill_(float(a))
                blk.gate_mlp.fill_(float(m))
    return model


def inputs(cfg, seed=7, B=2, S=24):
    """A numpy batch for ``cfg``: tokens, or the audio family's frame
    embeddings, and a vlm's media."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    else:
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.media_embed_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["media"] = rng.standard_normal(
            (B, cfg.n_media_tokens, cfg.media_embed_dim)).astype(np.float32)
    return out
