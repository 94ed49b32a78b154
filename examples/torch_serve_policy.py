"""Serving example on the PyTorch port: the InfServer path (paper §3.2)
with a big-arch backbone. Counterpart of `examples/serve_policy.py`; runs
on the card unless `--device cpu` is given.

Demonstrates the two serving steps the decode-shape dry-runs lower:
prefill (batch of observation-token prompts -> KV cache) + autoregressive
greedy decode — using the reduced gemma2 variant, as the twin does — then
the batched InfServer front-end serving many actor clients.

  PYTHONPATH=src python examples/torch_serve_policy.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.utils import resolve_device

# the twin's prompt length (below the reference's 64-token prefill reserve,
# where the two packages' prefills agree) and its request count
PROMPT, REQUESTS = 32, 32


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def generate(cfg, params, tokens, new_tokens):
    """Prefill `tokens` (B, T), then `new_tokens` greedy decode steps from
    the cache. Returns (prefill logits (B, T, V), the cache length, the
    greedy tokens (B, new_tokens + 1), ms per decode step)."""
    logits, _, state = prefill(params, cfg, {"tokens": tokens})
    length = int(state["length"][0])           # decode_step writes the state in place
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    out = [tok]
    sync(tokens.device)
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        lg, _, state = decode_step(params, cfg, tok, state)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)[..., 0:1]
        out.append(tok)
    sync(tokens.device)
    ms = 1e3 * (time.perf_counter() - t0) / max(1, new_tokens)
    return logits, length, torch.cat(out, 1).cpu().numpy(), ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("gemma2-2b").smoke()      # local+global pattern, softcaps
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)

    # 1) prefill: batch of prompts -> last-position logits + KV cache, then
    # 2) autoregressive decode with the cache (the serve_step the
    #    decode_32k / long_500k dry-run shapes lower at production scale)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    logits, length, tokens, ms = generate(cfg, params, toks, args.new_tokens)
    print(f"prefill: logits {tuple(logits.shape)}, cache length {length}")
    print(f"decode: {args.new_tokens} steps, {ms:.1f} ms/token/batch, "
          f"tokens[0] = {tokens[0].tolist()}")

    # 3) the batched InfServer front-end (SEED-style central inference)
    server = InfServer(cfg, num_actions=16, params=params, max_batch=32, device=dev)
    tickets = [server.submit(np.zeros((1, 8), np.int32)) for _ in range(REQUESTS)]
    acts = [server.get(t)[0] for t in tickets]
    print(f"infserver: served {server.requests_served} requests in "
          f"{server.batches_run} batched forward(s); actions[0:8] = "
          f"{[int(a[0]) for a in acts[:8]]}")
    return {"logits": logits.float().cpu().numpy(), "cache_length": length,
            "tokens": tokens, "decode_ms_per_token": ms,
            "requests_served": server.requests_served, "batches_run": server.batches_run}


if __name__ == "__main__":
    main()
