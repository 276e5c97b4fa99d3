"""CLI: prompt evaluation and interactive chat.

Port of ``vptq_tpu/serving/cli.py`` (reference: vptq/app_utils.py:
17-105, ``--model/--tokenizer/--prompt/--chat/--chat-system-prompt``),
with the same runtime-format and generation knobs and ``--device``: the
card unless the caller asks for the CPU. ``transformers`` is imported
only when the tokenizer is read.

    python -m vptq_tpu_torch --model DIR --prompt "..." [--device cpu]
    python -m vptq_tpu_torch --model DIR --chat
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

TP_REFUSAL = (
    "tensor parallelism (ROADMAP M16) is not ported; the port runs on one "
    "device"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vptq_tpu_torch",
        description="Serve a VPTQ-quantized LLM on an NVIDIA GPU.",
    )
    p.add_argument(
        "--model", type=str, required=True,
        help="checkpoint directory (HF layout with quantization_config)",
    )
    p.add_argument(
        "--tokenizer", type=str, default="",
        help="tokenizer path (defaults to --model)",
    )
    p.add_argument(
        "--prompt", type=str, default="",
        help="one-shot prompt to complete",
    )
    p.add_argument(
        "--chat", action="store_true",
        help="interactive chat via the tokenizer's chat template",
    )
    p.add_argument(
        "--chat-system-prompt", type=str, default="",
        help="system prompt for chat mode",
    )
    p.add_argument(
        "--runtime-format", type=str, default="int8",
        choices=(
            "int8", "int4", "int4-mixed", "int3", "int3-mixed",
            "int2", "int2-mixed",
            "bf16", "codebook",
        ),
        help="runtime weight format (see ARCHITECTURE.md); "
        "int4-mixed = calibrated GPTQ with the measured-most-"
        "sensitive sites kept int8; int3-mixed/int2-mixed = "
        "calibrated per-column int8 extraction over the int3/int2 "
        "plane formats (int2-mixed = the ~2.5-bit serving operating "
        "point); int3/int2 = raw plane formats (capacity probes)",
    )
    p.add_argument(
        "--calibration-tokens", type=int, default=0,
        help="calibrate the re-encode on this many synthetic tokens "
        "(GPTQ error feedback; implied 4096 for the mixed formats)",
    )
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--quantize-lm-head", action="store_true",
        help="re-encode the lm_head to int8 (halves its memory traffic)",
    )
    p.add_argument(
        "--prefix-cache-mb", type=int, default=0,
        help="enable prefix KV caching with this device memory budget "
        "(MiB); chat turns sharing a system prompt skip re-prefilling it",
    )
    p.add_argument(
        "--tp", type=int, default=0,
        help="tensor parallelism over this many devices: not ported, "
        "values above 1 are refused",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="where the model runs (cuda or cpu)",
    )
    return p


def _load(args):
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.serving.generate import Generator

    if args.tp and args.tp > 1:
        raise SystemExit(f"--tp {args.tp}: {TP_REFUSAL}")
    model = load_model(
        args.model,
        dtype=torch.bfloat16,
        runtime_format=args.runtime_format,
        quantize_lm_head=args.quantize_lm_head,
        device=args.device,
        calibration=args.calibration_tokens or None,
    )
    pc = None
    if args.prefix_cache_mb > 0:
        from vptq_tpu_torch.serving.prefix_cache import PrefixCache

        pc = PrefixCache(capacity_bytes=args.prefix_cache_mb * (1 << 20))
    gen = Generator(
        model, max_seq=args.max_seq, dtype=torch.bfloat16, prefix_cache=pc,
    )
    return model, gen


def _tokenizer(args):
    from transformers import AutoTokenizer

    path = args.tokenizer or args.model
    token = os.environ.get("HF_TOKEN")  # parity: app_utils.py:178-180
    kwargs = {"token": token} if token else {}
    return AutoTokenizer.from_pretrained(path, **kwargs)


def eval_prompt(gen, tokenizer, args) -> None:
    """One-shot streamed completion (reference app_utils.py:55-60)."""
    ids = tokenizer(args.prompt, return_tensors=None)["input_ids"]

    def stream(tok_id):
        text = tokenizer.decode([tok_id], skip_special_tokens=True)
        sys.stdout.write(text)
        sys.stdout.flush()

    sys.stdout.write(args.prompt)
    gen.generate(
        ids,
        max_new_tokens=args.max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        temperature=args.temperature,
        seed=args.seed,
        stream_callback=stream,
    )
    sys.stdout.write("\n")


def chat_loop(gen, tokenizer, args) -> None:
    """Interactive chat (reference app_utils.py:63-105)."""
    print(
        "chat mode; 'exit' to quit, 'clear' to reset history",
        file=sys.stderr,
    )
    messages = []
    if args.chat_system_prompt:
        messages.append(
            {"role": "system", "content": args.chat_system_prompt}
        )
    while True:
        try:
            user = input("You: ")
        except EOFError:
            break
        if user.strip().lower() == "exit":
            break
        if user.strip().lower() == "clear":
            messages = messages[:1] if args.chat_system_prompt else []
            continue
        if not user.strip():
            continue
        messages.append({"role": "user", "content": user})
        ids = tokenizer.apply_chat_template(
            messages, add_generation_prompt=True
        )
        pieces = []

        def stream(tok_id):
            text = tokenizer.decode([tok_id], skip_special_tokens=True)
            pieces.append(text)
            sys.stdout.write(text)
            sys.stdout.flush()

        sys.stdout.write("Assistant: ")
        gen.generate(
            ids,
            max_new_tokens=args.max_new_tokens,
            eos_token_id=tokenizer.eos_token_id,
            temperature=args.temperature,
            seed=args.seed,
            stream_callback=stream,
        )
        sys.stdout.write("\n")
        messages.append(
            {"role": "assistant", "content": "".join(pieces)}
        )


def main(argv=None) -> int:
    from vptq_tpu_torch.models.loader import entry_device

    args = build_parser().parse_args(argv)
    if not args.prompt and not args.chat:
        print("need --prompt or --chat", file=sys.stderr)
        return 2
    entry_device(args.device)
    tokenizer = _tokenizer(args)
    _, gen = _load(args)
    if args.chat:
        chat_loop(gen, tokenizer, args)
    else:
        eval_prompt(gen, tokenizer, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
