"""Batched LM serving on the PyTorch port: prefill a batch of prompts, then
decode tokens autoregressively with the KV/SSM cache.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b --new-tokens 24 [--device cpu]

``examples/serve_lm.py`` on ``repro_torch``, flag for flag and line for
line, for every decode-capable zoo family (dense / MoE / SSM / hybrid /
SWA ring buffer) at a reduced size with random weights. With
``--map-lookup`` it streams a reference corpus through the same model into
a NOMAD map and asks, through the public ``FrozenMap.neighbors`` query
(the call ``POST /explore`` uses), which corpus documents each decoded
continuation lands next to. It runs on the card unless ``--device`` names
another device.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument(
        "--map-lookup",
        action="store_true",
        help="fit a small map over a reference corpus embedded by this model "
        "and report each continuation's nearest corpus docs "
        "(public FrozenMap.neighbors)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.runtime import resolve_device
    from repro_torch.models import lm, steps as steps_lib

    device = resolve_device(args.device)
    # ssm_chunk=1 lets SSD prefill any prompt length (demo-sized model)
    cfg = reduced(ARCHS[args.arch], n_layers=4, ssm_chunk=1)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only; pick a decoder arch")
    print(f"serving {cfg.name} ({cfg.family}); batch={args.batch}, "
          f"prompt={args.prompt_len}, new={args.new_tokens}")

    params = lm.init_params(cfg, generator=torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)
    total = args.prompt_len + args.new_tokens
    if cfg.family == "vlm":
        prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len - cfg.n_vision_patches))
        patches = rng.normal(0, 1, (args.batch, cfg.n_vision_patches, cfg.d_model)).astype(np.float32)
        batch = {"tokens": torch.from_numpy(prompts[:, :-1]).to(device),
                 "patches": torch.from_numpy(patches).to(device)}
    else:
        prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        batch = {"tokens": torch.from_numpy(prompts[:, :-1]).to(device)}

    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)

    t0 = time.time()
    logits, stacked = prefill(params, batch)
    print(f"prefill: {time.time()-t0:.2f}s (logits {tuple(logits.shape)})")

    # load the prefill outputs into a decode cache sized for the full run
    cache = lm.init_cache(cfg, args.batch, total, filled=args.prompt_len - 1, device=device)
    cache = lm.load_cache_from_prefill(cfg, cache, stacked, args.prompt_len - 1)
    del stacked

    tok = torch.from_numpy(prompts[:, -1:]).to(device)
    generated = []
    t0 = time.time()
    for i in range(args.new_tokens):
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1:, :].argmax(-1)
        generated.append(tok[:, 0].cpu().numpy())
    dt = time.time() - t0
    gen = np.stack(generated, axis=1)
    print(f"decoded {args.new_tokens} tokens × {args.batch} seqs in {dt:.2f}s "
          f"({args.new_tokens*args.batch/dt:.1f} tok/s on {device.type})")
    print("sampled continuations (greedy):")
    for b in range(args.batch):
        print(f"  seq{b}: …{prompts[b,-5:].tolist()} → {gen[b,:12].tolist()}…")
    assert bool(torch.isfinite(logits).all())

    if args.map_lookup and cfg.family != "vlm":
        import tempfile

        from repro_torch.configs.base import NomadConfig
        from repro_torch.core.nomad import NomadProjection
        from repro_torch.data.synthetic import class_token_corpus
        from repro_torch.pipeline import embed_to_store, make_embed_fn
        from repro_torch.serve.frozen import FrozenMap

        # a reference corpus embedded by the same model, streamed to disk
        docs, classes = class_token_corpus(512, args.prompt_len, cfg.vocab_size)
        with tempfile.TemporaryDirectory() as d:
            store = embed_to_store(params, cfg, docs, d, doc_batch=128)
            ncfg = NomadConfig(
                n_points=store.shape[0], dim=store.shape[1],
                n_clusters=8, n_epochs=4, batch_size=512, chunk_rows=1024,
            )
            fz = FrozenMap.from_fit(NomadProjection(ncfg, device=device).fit(store), ncfg, device=device)
        # embed prompt+continuation with the same pooled forward, then ask
        # the frozen index (public API) what corpus docs live nearest
        fwd = make_embed_fn(cfg)
        full = np.concatenate([prompts, gen], axis=1).astype(np.int32)
        vecs = fwd(params, full).cpu().numpy()
        ids, dists = fz.neighbors(vecs, k=3)
        print("nearest corpus docs per continuation (id:class @ dist):")
        for b in range(args.batch):
            near = ", ".join(
                f"{i}:{classes[i]}@{d:.2f}"
                for i, d in zip(ids[b], dists[b]) if i >= 0
            )
            print(f"  seq{b}: {near}")

    print("OK")


if __name__ == "__main__":
    main()
