"""CLI: prompt evaluation and interactive chat.

Port of ``vptq_tpu/serving/cli.py`` (reference: vptq/app_utils.py:
17-105, ``--model/--tokenizer/--prompt/--chat/--chat-system-prompt``),
with the same runtime-format and generation knobs and ``--device``: the
card unless the caller asks for the CPU. ``transformers`` is imported
only when the tokenizer is read.

    python -m vptq_tpu_torch --model DIR --prompt "..." [--device cpu]
    python -m vptq_tpu_torch --model DIR --chat
    torchrun --nproc-per-node 2 -m vptq_tpu_torch --model DIR --prompt "..." \
        --tp 2
    torchrun --nproc-per-node 2 -m vptq_tpu_torch --model DIR --chat --tp 2

``--tp n`` runs as ``n`` ranks of a process group
(``parallel/distributed.py`` ``initialize`` reads torchrun's environment;
NCCL when every rank owns a card, gloo when they share one or on the
CPU), each loading and serving its shard of the model; every rank gets
the same arguments and only rank 0 prints. In chat, rank 0 alone reads
the terminal: it hands each turn's decision (the turn's token ids,
``clear`` or ``exit``) to every rank before any rank acts on it, and
every rank then runs the same ``Generator`` call.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist


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
        help="tensor parallelism over this many ranks of a process group "
        "(launch under torchrun --nproc-per-node N)",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="where the model runs (cuda or cpu)",
    )
    return p


def _load(args):
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.serving.generate import Generator

    mesh = _tp_mesh(args)
    model = load_model(
        args.model,
        dtype=torch.bfloat16,
        runtime_format=args.runtime_format,
        quantize_lm_head=args.quantize_lm_head,
        device=None if mesh is not None else args.device,
        calibration=args.calibration_tokens or None,
        mesh=mesh,
    )
    pc = None
    if args.prefix_cache_mb > 0:
        from vptq_tpu_torch.serving.prefix_cache import PrefixCache

        pc = PrefixCache(capacity_bytes=args.prefix_cache_mb * (1 << 20))
    gen = Generator(
        model, max_seq=args.max_seq, dtype=torch.bfloat16, prefix_cache=pc,
        mesh=mesh,
    )
    return model, gen


def _tp_mesh(args):
    """The ``Mesh(data=1, model=--tp)`` of this rank (joining the process
    group first), or None for ``--tp`` 0 or 1."""
    if not args.tp or args.tp <= 1:
        return None
    if args.runtime_format == "codebook":
        raise SystemExit(
            "--tp serves through the shard_map kernel path, which the "
            "codebook format does not support — use --runtime-format "
            "int8/int4/bf16"
        )
    from vptq_tpu_torch.parallel import distributed
    from vptq_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(
        backend="gloo" if args.device == "cpu" else None)
    if dist.get_world_size() != args.tp:
        raise SystemExit(
            f"--tp {args.tp} but {dist.get_world_size()} ranks in the group "
            f"(launch with torchrun --nproc-per-node {args.tp})"
        )
    return make_mesh(data=1, model=args.tp,
                     device="cpu" if args.device == "cpu" else None)


def _lead() -> bool:
    """Whether this process reads the input and prints: rank 0 under a
    process group, else the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _write(text: str) -> None:
    """stdout, on rank 0 only under a process group."""
    if _lead():
        sys.stdout.write(text)
        sys.stdout.flush()


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
        _write(tokenizer.decode([tok_id], skip_special_tokens=True))

    _write(args.prompt)
    gen.generate(
        ids,
        max_new_tokens=args.max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        temperature=args.temperature,
        seed=args.seed,
        stream_callback=stream,
    )
    _write("\n")


def _read_turn(tokenizer, args, messages) -> tuple:
    """Rank 0's next decision from the terminal: ("exit",), ("clear",) or
    ("ids", the turn's token ids); an empty line asks again."""
    while True:
        try:
            user = input("You: ")
        except EOFError:
            return ("exit",)
        if user.strip().lower() == "exit":
            return ("exit",)
        if user.strip().lower() == "clear":
            return ("clear",)
        if user.strip():
            messages.append({"role": "user", "content": user})
            return ("ids", tokenizer.apply_chat_template(
                messages, add_generation_prompt=True))


def chat_loop(gen, tokenizer, args) -> None:
    """Interactive chat (reference app_utils.py:63-105). Under a process
    group rank 0 reads each turn and broadcasts its decision before any
    rank acts, so that every rank makes the same ``Generator`` call."""
    lead = _lead()
    if lead:
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
        turn = _read_turn(tokenizer, args, messages) if lead else None
        if dist.is_initialized():
            from vptq_tpu_torch.parallel.distributed import broadcast_object

            turn = broadcast_object(turn)
        if turn[0] == "exit":
            break
        if turn[0] == "clear":
            messages = messages[:1] if args.chat_system_prompt else []
            continue
        pieces = []

        def stream(tok_id):
            text = tokenizer.decode([tok_id], skip_special_tokens=True)
            pieces.append(text)
            _write(text)

        _write("Assistant: ")
        gen.generate(
            turn[1],
            max_new_tokens=args.max_new_tokens,
            eos_token_id=tokenizer.eos_token_id,
            temperature=args.temperature,
            seed=args.seed,
            stream_callback=stream,
        )
        _write("\n")
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
