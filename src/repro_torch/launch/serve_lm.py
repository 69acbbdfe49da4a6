"""Serve a language model: batched prefill, then greedy decode.

Counterpart of ``examples/serve_lm.py``, with the same flags plus
``--seed`` and ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch attention on the host):

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch minitron-8b \\
        --batch 4 --prompt-len 2048 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch minitron-8b \\
        --smoke --device cpu

Every architecture of ``repro_torch.configs`` serves.  Weights are
random, drawn from a generator seeded with ``--seed`` at the
architecture's published widths (``--smoke``: its reduced config); the
prompts come from the same generator, and so do the stub frontends'
inputs (:func:`stub_inputs`): a vlm's patch embeddings, prepended to the
prompt, or an encdec's frames.  Exit code 0 iff every logit of the
last step is finite.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import DEVICES, resolve_device
from repro_torch.models import build_model
from repro_torch.train.steps import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stub_inputs(cfg, batch: int, generator: torch.Generator):
    """The stub frontends' inputs, f32 standard normals on the generator's
    device: a vlm's patch embeddings ``(batch, n_patches, d_model)``, an
    encdec's frames ``(batch, encoder_len, d_model)``; None for the other
    families."""
    n = {"vlm": cfg.n_patches, "encdec": cfg.encoder_len}.get(cfg.family)
    if n is None:
        return None
    return torch.randn((batch, n, cfg.d_model), generator=generator,
                       device=generator.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, generator=gen, device=dev)
    b, t, g = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                            device=dev)
    extra = stub_inputs(cfg, b, gen)

    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(prompts, extra)
    cache = model.extend_cache(cache, g)     # prompt + gen attention slots
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()

    out = [tok]
    for _ in range(g - 1):
        tok, logits, cache = decode(tok, cache)
        out.append(tok)
    tokens = torch.cat(out, dim=1).cpu()
    finite = bool(torch.isfinite(logits).all())
    t2 = time.perf_counter()
    print(f"[serve_lm] arch={cfg.name} prefill={t1 - t0:.3f}s "
          f"decode={(t2 - t1) / max(g - 1, 1) * 1e3:.1f}ms/tok")
    for i in range(min(b, 2)):
        print(f"[serve_lm] sample {i}: {tokens[i][:12].tolist()}")
    if not finite:
        print("[serve_lm] non-finite logits")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
