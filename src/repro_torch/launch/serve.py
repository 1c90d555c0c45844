"""Serving loop: batched prefill + decode with continuous batching slots
(the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --smoke --requests 8 --max-new 32 --device cpu

A fixed pool of batch slots runs lock-step greedy decode; finished
sequences free their slot, queued requests prefill into free slots
(prefill is batched per admission wave).  Prompts, slot order and the
printed lines are the reference's.  It runs on the GPU (``--device
cuda``, the default) unless asked for the CPU; without a GPU it raises.

The loop feeds token prompts and greedy tokens only, as the
reference's does: the vlm family (whose batches also carry media) and
the audio family (which takes frame embeddings, not tokens) cannot be
served by it.  The reference fails there with a ``KeyError``; ``serve``
raises ``NotImplementedError`` naming the reason.  Those models serve
through the Model API (``runtime.steps.make_prefill_step`` and
``make_decode_step``) driven directly.

One departure: the reference merges a wave's prefill cache into the live
cache along the first axis whose size equals the slot count, which is the
layer axis when ``n_layers == slots``.  Here every cache leaf is merged
along its known batch axis (``models.model.CACHE_BATCH_AXIS``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import CACHE_BATCH_AXIS, build_model
from repro_torch.runtime.steps import make_decode_step, make_prefill_step


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


def merge_cache(live: Dict[str, torch.Tensor], wave: Dict[str, torch.Tensor],
                slots: List[int]) -> None:
    """Copy a prefill wave's cache rows into the live cache's ``slots``,
    in place, along each leaf's batch axis."""
    idx = torch.as_tensor(slots, dtype=torch.int64,
                          device=live["pos"].device)
    for name, new in wave.items():
        live[name].index_copy_(CACHE_BATCH_AXIS[name], idx, new)


def serve(cfg, params=None, *, requests: int = 8, slots: int = 4,
          prompt_len: int = 16, max_new: int = 32, seed: int = 0,
          device="cuda", impl: str = "cuda", verbose: bool = False):
    """Serve ``requests`` random prompts through ``slots`` batch slots.

    ``params``: a state dict for the model (``load_jax_params``), or None
    to draw the parameters from ``seed`` on ``device``.  Returns a dict:
    ``tokens`` {rid: generated token ids}, ``steps`` (decode steps),
    ``served``, ``tok_s`` (served * max_new / wall seconds), ``seconds``,
    ``prefill_s`` and ``prefill_waves`` (admission waves, each a batched
    prefill), ``decode_s``, ``first_logits`` (the first wave's prefill
    logits, float32 on the CPU).  Host-clock times; every step ends in a
    device-to-host copy of its argmax, which synchronises.  The vlm and
    audio families raise ``NotImplementedError``."""
    if cfg.family == "vlm" or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: the serving loop feeds tokens only, as the "
            f"reference's does; the {cfg.family} family takes "
            + ("media beside its tokens" if cfg.family == "vlm" else
               "embeddings, not tokens")
            + " (serve it through runtime.steps.make_prefill_step and "
              "make_decode_step)")
    model = build_model(cfg, device=device, seed=seed, impl=impl)
    if params is not None:
        model.load_state_dict(params)
    B = slots
    max_len = prompt_len + max_new

    rng = np.random.default_rng(seed)
    queue = [Request(i, rng.integers(2, cfg.vocab_size,
                                     size=prompt_len).astype(np.int32),
                     max_new)
             for i in range(requests)]
    done: List[Request] = []
    live: List[Optional[Request]] = [None] * B

    decode = make_decode_step(model)
    prefill = make_prefill_step(model, cache_len=max_len)

    cache = model.init_cache(B, max_len)
    positions = np.zeros(B, np.int64)
    stats = {"prefill_s": 0.0, "prefill_waves": 0, "decode_s": 0.0,
             "first_logits": None}
    served, t0, steps = 0, time.perf_counter(), 0

    def admit():
        free = [i for i, s in enumerate(live) if s is None]
        wave = []
        while free and queue:
            slot = free.pop()
            req = queue.pop(0)
            live[slot] = req
            wave.append((slot, req))
        if not wave:
            return
        ta = time.perf_counter()
        toks = np.stack([r.prompt for _, r in wave])
        logits, wave_cache = prefill({"tokens": toks})
        merge_cache(cache, wave_cache, [s for s, _ in wave])
        nxt = torch.argmax(logits, -1).cpu().numpy()
        stats["prefill_s"] += time.perf_counter() - ta
        stats["prefill_waves"] += 1
        if stats["first_logits"] is None:
            stats["first_logits"] = logits.float().cpu()
        for j, (slot, req) in enumerate(wave):
            positions[slot] = len(req.prompt)
            req.generated.append(int(nxt[j]))

    admit()
    while any(s is not None for s in live) or queue:
        td = time.perf_counter()
        toks = np.array([[r.generated[-1] if r else 0] for r in live],
                        np.int64)
        logits, cache = decode(cache, {"tokens": toks}, positions)
        steps += 1
        nxt = torch.argmax(logits, -1).cpu().numpy()
        stats["decode_s"] += time.perf_counter() - td
        for i, req in enumerate(live):
            if req is None:
                continue
            positions[i] += 1
            req.generated.append(int(nxt[i]))
            if len(req.generated) >= req.max_new:
                req.done = True
                served += 1
                done.append(req)
                if verbose:
                    print(f"[serve] rid={req.rid} done: "
                          f"{req.generated[:8]}... ({len(req.generated)} "
                          f"toks)")
                live[i] = None
        if any(s is None for s in live) and queue:
            admit()
    dt = time.perf_counter() - t0
    tput = served * max_new / dt
    if verbose:
        print(f"[serve] served {served} requests, {steps} decode steps, "
              f"{tput:.1f} tok/s")
    return {"tokens": {r.rid: list(r.generated) for r in done},
            "steps": steps, "served": served, "tok_s": tput,
            "seconds": dt, **stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    serve(cfg, requests=args.requests, slots=args.slots,
          prompt_len=args.prompt_len, max_new=args.max_new, seed=args.seed,
          device=args.device, verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
