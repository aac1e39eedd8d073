"""Batched LM serving demo (counterpart of ``repro.launch.serve``): prefill
a prompt batch, decode greedily. Runs on the card unless ``--device cpu``
asks for the CPU; the CLI runs one process, ``generate`` also a sharded
model on a mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, toks: torch.Tensor, cfg, n_tokens: int, mesh=None):
    """Prefill ``toks`` [B, S], then decode greedily until ``n_tokens``
    tokens are generated. The cache is right-padded after the prefill to
    hold every generated token (at most the window, whose cache the prefill
    has already rolled). Returns (tokens [B, n_tokens] int32, the cache,
    which holds every position but the last token's, and the prefill's and
    the decode loop's seconds, each ended by a device sync). On a mesh of
    several ranks every rank calls it with its blocks of the weights and
    the global prompt: the tokens come back whole on every rank, the cache
    as this rank's blocks (``models.transformer.cache_specs``)."""
    from repro_torch.train import steps as S

    dev = toks.device
    batch, prompt_len = toks.shape
    cache_len = prompt_len + n_tokens
    t0 = time.perf_counter()
    nxt, cache = S.lm_prefill_step(params, toks, cfg, mesh)
    tcap = cache["k"].shape[2]
    want = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
    if tcap < want:
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, want - tcap))
                 for k, v in cache.items()}
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [nxt]
    t0 = time.perf_counter()
    for i in range(n_tokens - 1):
        nxt, cache = S.lm_decode_step(params, out[-1], cache, prompt_len + i, cfg, mesh)
        out.append(nxt)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return torch.stack(out, dim=1), cache, prefill_s, decode_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.graphs.structures import resolve_device
    from repro_torch.models import transformer as T

    if registry.family_of(args.arch) != "lm":
        raise SystemExit(f"{args.arch}: the serving demo is for LM archs")
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=True)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev).params
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    gen, _, prefill_s, decode_s = generate(params, toks, cfg, args.tokens)
    print(f"prefill: {args.batch}x{args.prompt_len} in {prefill_s:.2f}s")
    steps = args.tokens - 1
    print(f"decoded {steps} steps x batch {args.batch} in {decode_s:.2f}s "
          f"({steps * args.batch / max(decode_s, 1e-9):.1f} tok/s)")
    print("sample:", gen[0][:12].tolist())
    return gen


if __name__ == "__main__":
    main()
