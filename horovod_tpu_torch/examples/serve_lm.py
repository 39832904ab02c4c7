"""Serve a transformer LM: the port's twin of examples/serve_lm.py.

Loads the serving checkpoint ``transformer_lm --export`` writes (params,
model config, tokenizer metadata; the JAX package's exports load too),
builds a continuous-batching :class:`InferenceEngine` on the GPU (or
``--device cpu``), warm-starts it, and either answers one prompt
(``--prompt`` / ``--tokens``) or runs the HTTP front door (``--serve``:
``/generate``, ``/prefixes``, ``/metrics`` and ``/healthz`` on one port).

    # train tiny + export, then one-shot generate:
    python -m horovod_tpu_torch.examples.transformer_lm --device cpu \
        --export /tmp/lm-ckpt
    python -m horovod_tpu_torch.examples.serve_lm /tmp/lm-ckpt \
        --device cpu --tokens 5,3,8,1 -n 16

    # HTTP server (POST {"text": ..., "max_tokens": N} to /generate):
    python -m horovod_tpu_torch.examples.serve_lm /tmp/lm-ckpt --serve \
        --port 9100

    # speculative decoding with a draft model's export (same vocab):
    python -m horovod_tpu_torch.examples.serve_lm /tmp/lm-ckpt \
        --draft /tmp/draft-ckpt --tokens 5,3,8 -n 16
"""

from __future__ import annotations

import argparse
import json

from horovod_tpu_torch.serving import InferenceEngine, LMServer
from horovod_tpu_torch.serving.server import decode_tokens, encode_text
from horovod_tpu_torch.utils.checkpoint import load_serving_checkpoint


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint",
                    help="directory written by transformer_lm --export")
    ap.add_argument("--prompt", type=str, default=None,
                    help="text prompt (byte tokenizer; needs a "
                         "vocab_size >= 256 model)")
    ap.add_argument("--tokens", type=str, default=None,
                    help="comma-separated token-id prompt")
    ap.add_argument("-n", "--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--serve", action="store_true",
                    help="run the HTTP front door instead of one shot")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--slots", type=int, default=8,
                    help="decode batch slots (continuous batching)")
    ap.add_argument("--draft", type=str, default=None,
                    help="serving checkpoint of a DRAFT model (same "
                         "vocab): speculative decoding with the "
                         "bitwise-greedy acceptance rule")
    ap.add_argument("--spec-tokens", type=int, default=None,
                    help="draft proposals per iteration (with --draft; "
                         "default HVD_TPU_SPEC_TOKENS)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the shared-prefix page cache")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    params, cfg, meta = load_serving_checkpoint(args.checkpoint)
    draft = None
    if args.draft is not None:
        dparams, dcfg, _ = load_serving_checkpoint(args.draft)
        draft = (dparams, dcfg)
    engine = InferenceEngine(params, cfg, device=args.device,
                             max_slots=args.slots, draft=draft,
                             spec_tokens=args.spec_tokens,
                             prefix_cache=(False if args.no_prefix_cache
                                           else None))

    if args.serve:
        server = LMServer(engine, port=args.port).start()
        print(f"serve_lm: listening on :{server.port} "
              f"(/generate /prefixes /metrics /healthz), "
              f"{meta['tokenizer']['kind']} tokenizer, "
              f"slots={args.slots}, device={engine.device}", flush=True)
        try:
            server._thread.join()
        except KeyboardInterrupt:
            server.close()
        return

    if args.tokens:
        prompt = [int(t) for t in args.tokens.split(",")]
    elif args.prompt is not None:
        prompt = encode_text(args.prompt, cfg.vocab_size)
    else:
        ap.error("need --prompt or --tokens (or --serve)")
    engine.warm_start()
    out = engine.generate(prompt, max_new_tokens=args.max_tokens,
                          temperature=args.temperature)
    text = decode_tokens(out, cfg.vocab_size)
    print(json.dumps({"prompt": prompt, "tokens": out, "text": text}))
    print("serve_lm: OK")


if __name__ == "__main__":
    main()
