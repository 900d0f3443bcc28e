"""Serving launcher (port of ``repro.launch.serve``): batched prefill and
greedy or sampled decode of a batch of requests.

``python -m repro_torch.launch.serve --arch hymba-1.5b --requests 4``

Requests of different prompt lengths are right-aligned into one batch,
prefilled once (on the card: kernels B5 and B6 in every layer), replayed
token by token through ``decode_step`` to fill the caches, then decoded
step by step; finished requests are masked out. Unlike the reference, the
prefill is not pinned to the plain route: the device of the model decides.
Its logits are discarded, as in the reference, so the returned tokens do
not depend on it.

The batch runs under :func:`repro_torch.linalg.use`, so a caller-supplied
``context`` (e.g. ``ExecutionContext(obs=trace)``) scopes it, and the loop
records ``serve.batch`` / ``serve.prefill`` / ``serve.decode`` spans and
one ``serve.request`` event per finished request through
:mod:`repro_torch.obs`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import linalg
from repro_torch import obs as _obs
from repro_torch.configs import registry
from repro_torch.launch.train import reduce_config
from repro_torch.linalg.context import current, resolved_obs
from repro_torch.models import model_zoo as zoo


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (len,) int32
    max_new: int


def serve_batch(model, cfg, requests: List[Request], max_len: int,
                temperature: float = 0.0, context=None,
                generator: Optional[torch.Generator] = None):
    """Prefill and decode a batch of requests on the model's device;
    returns (token lists, stats).

    Sampling at ``temperature > 0`` draws from ``generator`` (default: one
    on the model's device seeded with 0); greedy decoding draws nothing.
    ``context`` scopes the batch through :func:`repro_torch.linalg.use`
    (``None`` inherits the ambient context; an ``obs`` trace on it
    captures the serve spans).
    """
    with contextlib.ExitStack() as st:
        st.enter_context(linalg.use(context))
        tr = resolved_obs(current())
        if tr is not _obs.current_trace():
            st.enter_context(_obs.capture(tr))
        if generator is None and temperature > 0:
            generator = torch.Generator(device=model.device).manual_seed(0)
        return _serve_batch(model, cfg, requests, max_len, temperature,
                            generator)


def _serve_batch(model, cfg, requests: List[Request], max_len: int,
                 temperature: float, generator):
    dev = model.device
    b = len(requests)
    plens = np.array([len(r.prompt) for r in requests])
    pmax = int(plens.max())
    toks = np.zeros((b, pmax), np.int64)           # right-aligned prompts
    for i, r in enumerate(requests):
        toks[i, pmax - len(r.prompt):] = r.prompt
    tokens = torch.from_numpy(toks).to(dev)

    with _obs.span("serve.batch", cat="serve", requests=b, max_len=max_len,
                   model=cfg.name, prompt_max=pmax):
        with _obs.span("serve.prefill", cat="serve", batch=b,
                       prompt_max=pmax):
            # prefill the whole padded batch (its logits are not used)
            zoo.prefill(model, {"tokens": tokens}, cfg)
            caches = zoo.init_caches(model, cfg, b, max_len)
            # replay the prompts through decode_step to fill the caches
            # (simple and exact; a production server would scatter the
            # prefill's KVs directly)
            last = None
            for t in range(pmax):
                last, caches = zoo.decode_step(model, tokens[:, t:t + 1],
                                               cfg, caches, t)

        out = [list(r.prompt) for r in requests]
        done = np.zeros(b, bool)
        max_new = max(r.max_new for r in requests)
        t0 = time.perf_counter()
        cur, steps = last, 0
        with _obs.span("serve.decode", cat="serve", batch=b,
                       max_new=max_new) as dec:
            for n in range(max_new):
                lg = cur[:, -1].float()
                if temperature > 0:
                    probs = torch.softmax(lg / temperature, dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
                else:
                    nxt = torch.argmax(lg, dim=-1)
                nxt = nxt.to(torch.int32).cpu().numpy()
                steps = n + 1
                for i in range(b):
                    if not done[i]:
                        out[i].append(int(nxt[i]))
                        if (len(out[i]) - len(requests[i].prompt)
                                >= requests[i].max_new):
                            done[i] = True
                            _obs.event("serve.request", cat="serve", index=i,
                                       prompt_len=int(plens[i]),
                                       new_tokens=len(out[i]) - int(plens[i]))
                if done.all():
                    break
                cur, caches = zoo.decode_step(
                    model, torch.from_numpy(nxt.astype(np.int64))[:, None]
                    .to(dev), cfg, caches, pmax + n)
            dt = time.perf_counter() - t0
            tok_s = (b * steps) / max(dt, 1e-9)
            dec.annotate(steps=steps, decode_tokens_per_s=tok_s)
    return out, {"decode_tokens_per_s": tok_s, "steps": steps}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCHS, default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = reduce_config(registry.get_config(args.arch), args.layers,
                        args.d_model, vocab=512, heads=4)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = zoo.init(cfg, torch.Generator(device=args.device).manual_seed(0),
                     device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, size=rng.integers(4, 12)
                                 ).astype(np.int32), args.max_new)
            for _ in range(args.requests)]
    outs, stats = serve_batch(model, cfg, reqs, max_len=64)
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={len(reqs[i].prompt)} -> {len(o)} tokens")
    print(stats)


if __name__ == "__main__":
    main()
