"""Batched serving driver: prefill + greedy decode over batches of requests.

The port of ``python -m repro.launch.serve``: the same flags (``--no-mesh``
is accepted; the port serves on one device) and printed lines, plus
``--device`` (default: the CUDA device).  Requests are packed into fixed
batches in order (the last one padded with copies of its last prompt),
prefilled once into a cache of prompt + ``max_new`` slots, then decoded
greedily one token a step; :func:`serve` does it for given weights and
prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model_api


class ServeResult(NamedTuple):
    """What :func:`serve` returns.

    tokens: ``(R, max_new)`` int64 numpy array, the greedy tokens of each
        request in request order.
    logits: ``(R, max_new, V)`` float32 (float64 for a float64 model) on
        the model's device, each step's logits (prefill's last position
        first), when asked for; else None.
    prefill_s / decode_s: wall seconds of the prefills and of the decode
        loops, each ending in a device synchronise.
    decode_steps: decode steps run, ``batches × (max_new − 1)``.
    batches: batches served.
    """

    tokens: np.ndarray
    logits: torch.Tensor | None
    prefill_s: float
    decode_s: float
    decode_steps: int
    batches: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params, prompts, *, batch: int, max_new: int,
          return_logits: bool = False) -> ServeResult:
    """Serve ``prompts`` (``(R, P)`` token ids) with ``params`` (the model's
    module, on the device it runs on): each batch prefilled into a cache of
    ``P + max_new`` slots, then ``max_new − 1`` greedy decode steps.  The
    tokens stay on the device until their batch ends."""
    prompts = np.asarray(prompts)
    R, P = prompts.shape
    if R < 1 or batch < 1 or max_new < 1:
        raise ValueError(f"need requests, batch and max_new >= 1, got {R}, {batch}, {max_new}")
    dev = params.embedding.device
    prefill = make_prefill_step(cfg, seq_len=P + max_new)
    decode = make_decode_step(cfg)
    tokens, logits = [], []
    prefill_s = decode_s = 0.0
    steps = batches = 0
    for start in range(0, R, batch):
        chunk = prompts[start:start + batch]
        real = len(chunk)
        if real < batch:                                  # pad the final batch
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch - real, axis=0)])
        toks = torch.tensor(chunk, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        last, cache = prefill(params, {"tokens": toks})
        _sync(dev)
        t1 = time.perf_counter()
        outs, seen = [last.argmax(-1)], [last]
        for _ in range(max_new - 1):
            last, cache = decode(params, cache, {"tokens": outs[-1][:, None]})
            outs.append(last.argmax(-1))
            if return_logits:
                seen.append(last)
        _sync(dev)
        prefill_s += t1 - t0
        decode_s += time.perf_counter() - t1
        steps += max_new - 1
        batches += 1
        tokens.append(torch.stack(outs, dim=1)[:real].cpu().numpy())
        if return_logits:
            logits.append(torch.stack(seen, dim=1)[:real])
    return ServeResult(tokens=np.concatenate(tokens),
                       logits=torch.cat(logits) if return_logits else None,
                       prefill_s=prefill_s, decode_s=decode_s, decode_steps=steps,
                       batches=batches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-mesh", action="store_true",
                    help="accepted for the reference's command lines; the port serves on one device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "encdec":
        raise SystemExit("use the whisper example for enc-dec serving")
    dev = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} mesh=None device={dev}")

    params = model_api.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = np.stack([rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
                        for _ in range(args.requests)])

    t0 = time.time()
    res = serve(cfg, params, prompts, batch=args.batch, max_new=args.max_new)
    dt = time.time() - t0
    print(f"[serve] {len(res.tokens)} requests, {res.decode_steps} decode steps "
          f"in {dt:.2f}s ({res.decode_steps * args.batch / dt:.1f} tok/s)")
    print("[serve] sample output tokens:", res.tokens[0][:10])


if __name__ == "__main__":
    main()
