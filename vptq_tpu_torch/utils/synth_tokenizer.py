"""Minimal byte-level tokenizer directory for tests and demos.

The port's copy of ``vptq_tpu/utils/synth_tokenizer.py``: a byte-level
vocabulary (ids 0-2 ``<pad>``, ``<s>``, ``</s>``; the 256 bytes from id
3 on, in the order of the ``ByteLevel`` alphabet) with a trivial chat
template, saved in HF layout so that ``AutoTokenizer.from_pretrained``
reads it. ``tokenizers`` and ``transformers`` are imported only when a
directory is written.
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["CHAT_TEMPLATE", "write_byte_tokenizer"]

CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ message['role'] }}: {{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}assistant:{% endif %}"
)


def write_byte_tokenizer(path: str, vocab_size: int = 512) -> Path:
    """Write a byte-level tokenizer dir loadable by AutoTokenizer.

    ``vocab_size`` must be >= 259 (256 bytes + bos/eos/pad); extra ids
    stay unused so the tokenizer fits any synth checkpoint vocab.
    """
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    if vocab_size < 259:
        raise ValueError("vocab_size must be >= 259")

    # ids 0..2: specials; 3..258: bytes via the ByteLevel alphabet
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}
    for i, ch in enumerate(sorted(alphabet)):
        vocab[ch] = 3 + i
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()

    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok,
        bos_token="<s>",
        eos_token="</s>",
        pad_token="<pad>",
        chat_template=CHAT_TEMPLATE,
    )
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    fast.save_pretrained(out)
    return out
