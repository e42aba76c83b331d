"""Serving example on the card (the PyTorch port's twin of
``examples/serve_decode.py``): prefill a batch of prompts, then greedy-
decode with the KV-cache decode step, whose attention is the flash-decode
kernel (K6) on the card.  With --engine, requests run through the
slot-based continuous-batching engine instead (more requests than slots).
Weights are random, from a seed, at the arch's smoke config.

    PYTHONPATH=src python examples/torch/serve_decode.py --steps 16
    PYTHONPATH=src python examples/torch/serve_decode.py --engine \\
        --requests 6
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.registry import ARCH_IDS, get_config, model_api
from repro_torch.serve import Request, ServeEngine


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--engine", action="store_true",
                    help="serve via the slot-based batching engine")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="the card or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)  # reduced family
    api = model_api(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen)
    B, S = args.batch, args.prompt_len

    if args.engine:
        rng = np.random.default_rng(0)
        max_len = S + args.steps + 8
        if cfg.encdec:
            max_len = max(max_len, cfg.max_source_positions)
        eng = ServeEngine(params, cfg, slots=args.batch, max_len=max_len,
                          device=dev)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                            rng.integers(4, S)).astype(
                            np.int32),
                        max_new_tokens=args.steps)
                for _ in range(args.requests)]
        out = eng.run(reqs)
        for i, r in enumerate(out):
            print(f"  req {i} ({len(r.prompt)}-token prompt): {r.output}")
        print(f"served {args.requests} requests over {args.batch} slots")
        return out

    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32),
             "labels": torch.zeros((B, S), dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        npatch = int(S * cfg.vision_patches_frac)
        batch["patch_embeds"] = torch.randn(B, npatch, cfg.d_model,
                                            generator=gen, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        batch["positions3"] = torch.stack([pos, pos, pos])
    if cfg.encdec:
        batch["frames"] = torch.randn(B, cfg.max_source_positions,
                                      cfg.d_model, generator=gen, device=dev)

    print(f"prefill {args.arch} (smoke config) on {dev}: batch={B} "
          f"prompt={S}")
    logits, caches = api.prefill(params, cfg, batch,
                                 cache_len=S + args.steps)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(args.steps - 1):
        pos = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
        logits, caches = api.decode_step(params, cfg, tok, caches, pos)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
    gen_ids = torch.cat(out, dim=1).cpu()
    print("generated token ids:")
    for b in range(B):
        print(f"  seq {b}: {gen_ids[b].tolist()}")
    print(f"decoded {args.steps} tokens x {B} sequences with a "
          f"{S + args.steps}-slot KV cache")
    return gen_ids


if __name__ == "__main__":
    main()
