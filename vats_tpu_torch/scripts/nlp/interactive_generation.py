"""Interactive generation CLI.

The port's counterpart of ``scripts/nlp/interactive_generation.py``: load a
checkpoint (model args from its metadata), then generate for each prompt
read from stdin until 'quit', 'exit' or the end of input.  ``--paged``
serves through the paged KV cache, ``--quantize int8`` with int8 weights,
``--kv-quant int8`` with int8 KV pages (implies ``--paged``).

    python -m vats_tpu_torch.scripts.nlp.interactive_generation \\
        --ckpt checkpoints/nlp/best_model

Runs on the card unless ``--device cpu`` is given.  The tokenizer is
``AutoTokenizer.from_pretrained(--tokenizer)`` (a download) unless the
caller of :func:`main` passes one; ``stdin`` may be any text stream.
:func:`main` returns the generated texts in order.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="checkpoints/nlp/best_model")
    p.add_argument("--tokenizer", default="mistralai/Mistral-7B-v0.1")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--paged", action="store_true",
                   help="serve through the paged-KV decode kernel")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only int8 serving")
    p.add_argument("--kv-quant", choices=["int8"], default=None,
                   help="int8 paged KV pages (implies --paged)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, tokenizer=None,
         stdin: Optional[TextIO] = None) -> List[str]:
    args = parse_args(argv)
    from vats_tpu_torch.checkpoint import load_checkpoint
    from vats_tpu_torch.configs import GenerationArgs, ModelArgs
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.inference import TokenGenerator

    device = resolve_device(args.device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        if tokenizer.pad_token_id is None:
            tokenizer.pad_token = tokenizer.eos_token
    stdin = stdin if stdin is not None else sys.stdin

    restored, meta = load_checkpoint(args.ckpt)
    model_args = ModelArgs.from_dict(meta["model_args"])
    gen = TokenGenerator(
        model_args, params=restored["params"],
        use_paged=args.paged or args.kv_quant is not None,
        quantize=args.quantize, kv_quant=args.kv_quant, device=device,
    )
    gen_args = GenerationArgs(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        pad_token_id=tokenizer.pad_token_id,
        eos_token_id=tokenizer.eos_token_id,
    )

    print("Interactive generation — type 'quit' to exit.")
    outputs = []
    while True:
        print("> ", end="", flush=True)
        line = stdin.readline()
        if not line:
            break
        prompt = line.rstrip("\n")
        if prompt.strip().lower() in ("quit", "exit"):
            break
        outputs.append(gen.generate_tokens(prompt, gen_args, tokenizer))
        print(outputs[-1])
    return outputs


if __name__ == "__main__":
    main()
