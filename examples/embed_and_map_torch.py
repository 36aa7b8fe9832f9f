"""End to end on the PyTorch port: train a small LM from the model
zoo, stream a corpus through it into an on-disk store, map the embeddings
with NOMAD Projection, train the inverse head, and explore the result
(model → vectors → map → explore) in one script.

    PYTHONPATH=src python examples/embed_and_map_torch.py [--train-steps 300] [--device cpu]

``examples/embed_and_map.py`` on ``repro_torch``, flag for flag and line for
line. The embed stage is ``repro_torch.pipeline``'s streaming path: pooled
forwards land directly in ``write_sharded()`` chunks and the fit consumes
the store, so the full ``(N, D)`` embedding matrix never materialises on
the host. ``--materialize`` collects the matrix first (the same map);
``--rss-compare`` runs streamed-then-materialized in one process and
reports both ``ru_maxrss`` watermarks. It runs on the card unless
``--device`` names another device.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import argparse
import json
import time

import numpy as np


def _rss_mb() -> float:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return ru / 1024.0 if sys.platform != "darwin" else ru / (1024.0 * 1024.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", help="zoo arch (reduced)")
    ap.add_argument("--train-steps", type=int, default=300, help="LM pre-training steps")
    ap.add_argument("--docs", type=int, default=4000)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--doc-batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=30, help="map fit epochs")
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--inverse-steps", type=int, default=500)
    ap.add_argument("--workdir", default="", help="keep artifacts here (default: tmp)")
    ap.add_argument("--materialize", action="store_true",
                    help="collect the (N, D) matrix, then fit")
    ap.add_argument("--rss-compare", action="store_true",
                    help="embed streamed then materialized, report both RSS "
                    "watermarks, skip the fit")
    ap.add_argument("--json", default="", help="write results to this file")
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import NomadConfig
    from repro_torch.core.runtime import resolve_device
    from repro_torch.data.embeddings import embed_corpus
    from repro_torch.data.loader import TokenStream
    from repro_torch.data.synthetic import class_token_corpus
    from repro_torch.models import lm, steps as steps_lib
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.pipeline import embed_to_store

    device = resolve_device(args.device)
    report = {"example": "embed_and_map_torch", "config": vars(args)}

    # ---- 1. train a small LM of the chosen family on synthetic tokens --------
    cfg = reduced(
        ARCHS[args.arch], n_layers=args.n_layers, d_model=args.d_model,
        vocab_size=512,
    )
    print(f"training {cfg.name} ({cfg.family}) for {args.train_steps} steps …")
    params = lm.init_params(cfg, generator=torch.Generator(device).manual_seed(0))
    if args.train_steps > 0:
        opt = AdamW(
            schedule=warmup_cosine(3e-3, min(50, args.train_steps), args.train_steps),
            moment_dtype="float32",
        )
        opt_state = opt.init(list(params.parameters()))
        step_fn = steps_lib.make_train_step(cfg, opt)
        stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq_len)
        t0 = time.time()
        for s in range(args.train_steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in stream.batch(s, 16).items()}
            params, opt_state, loss = step_fn(params, opt_state, batch)
            if s % 50 == 0:
                print(f"  step {s:4d}  loss {float(loss):.4f}")
        print(f"trained in {time.time()-t0:.1f}s; final loss {float(loss):.3f}")

    # ---- 2. a corpus with latent classes, embedded by the trained model ------
    tokens, classes = class_token_corpus(
        args.docs, args.seq_len, cfg.vocab_size, n_classes=8
    )
    workdir = args.workdir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"embed_and_map_{os.getpid()}"
    )
    store_dir = os.path.join(workdir, "embeddings")
    token_batches = [
        tokens[i : i + args.doc_batch] for i in range(0, args.docs, args.doc_batch)
    ]

    if args.rss_compare:
        # streamed FIRST: ru_maxrss is a monotone watermark, so the order
        # streamed → materialized is the only one that can show the gap
        t0 = time.time()
        store = embed_to_store(
            params, cfg, token_batches, store_dir, doc_batch=args.doc_batch
        )
        streamed_mb = _rss_mb()
        print(f"streamed embed: {store.shape} in {time.time()-t0:.1f}s, "
              f"peak RSS {streamed_mb:.0f} MB")
        t0 = time.time()
        vecs = embed_corpus(params, cfg, token_batches)
        mono_mb = _rss_mb()
        print(f"materialized embed: {vecs.shape} in {time.time()-t0:.1f}s, "
              f"peak RSS {mono_mb:.0f} MB")
        np.testing.assert_array_equal(store.materialize(), vecs)
        print("streamed store is bit-identical to the materialized matrix")
        report["rss_compare"] = {
            "streamed_peak_mb": streamed_mb,
            "monolithic_peak_mb": mono_mb,
        }
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=2)
        print("OK — RSS comparison complete")
        return

    print(f"embedding {args.docs} documents "
          f"({'materialized' if args.materialize else 'streamed → ' + store_dir}) …")
    t0 = time.time()
    if args.materialize:
        x = embed_corpus(params, cfg, token_batches)
    else:
        x = embed_to_store(
            params, cfg, token_batches, store_dir, doc_batch=args.doc_batch
        )
    report["embed_s"] = time.time() - t0
    print(f"corpus embeddings: {x.shape} ({report['embed_s']:.1f}s)")

    # ---- 3. NOMAD-map the embeddings (the fit consumes the store) ------------
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy
    from repro_torch.metrics.neighborhood import _topk_neighbors
    from repro_torch.serve.frozen import FrozenMap

    ckdir = os.path.join(workdir, "map")
    ncfg = NomadConfig(
        n_points=x.shape[0], dim=x.shape[1], n_clusters=args.clusters,
        n_neighbors=15, n_noise=32, n_exact_negatives=8, batch_size=512,
        n_epochs=args.epochs, chunk_rows=1024, checkpoint_dir=ckdir,
    )
    t0 = time.time()
    fit = NomadProjection(ncfg, device=device).fit(x)
    report["fit_s"] = time.time() - t0
    emb = fit.embedding
    vecs = x.materialize() if hasattr(x, "materialize") else x
    np10 = neighborhood_preservation(vecs, emb, k=10, n_queries=500, device=device)
    rta = random_triplet_accuracy(vecs, emb, 10_000)
    # do documents of the same class land together?
    e = torch.from_numpy(emb).to(device)
    nb = _topk_neighbors(e[:400], e, 10).cpu().numpy()
    purity = float(np.mean(classes[nb] == classes[:400, None]))
    print(f"map quality: NP@10={np10:.4f} triplet={rta:.4f} class-purity={purity:.3f}")
    report.update(np10=np10, triplet=rta, class_purity=purity)
    assert purity > 0.5, "document classes did not separate"

    # ---- 4. inverse head + explore: "what lives at this spot?" ---------------
    from repro_torch.pipeline import inverse_from_frozen, roundtrip_score, save_inverse

    frozen = FrozenMap.from_fit(fit, ncfg, device=device)
    t0 = time.time()
    inv = inverse_from_frozen(frozen, hidden=(64, 64), steps=args.inverse_steps)
    report["inverse_train_s"] = time.time() - t0
    save_inverse(ckdir, inv)
    r2 = roundtrip_score(inv, emb, vecs, device=device)
    report["inverse_roundtrip_r2"] = r2
    print(f"inverse head: R²={r2:.3f} "
          f"({args.inverse_steps} steps, {report['inverse_train_s']:.1f}s) "
          f"→ {ckdir}/inverse.npz")
    spot = emb[0]
    ids, dists = frozen.neighbors(inv.decode(spot, device=device)[0], k=5)
    near = [int(i) for i in ids if i >= 0]
    same = float(np.mean(classes[near] == classes[0])) if near else 0.0
    print(f"explore({spot.round(2).tolist()}): docs {near} "
          f"(class match {same:.2f} vs doc 0)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    print("OK — model → embeddings → map → explore pipeline complete")


if __name__ == "__main__":
    main()
