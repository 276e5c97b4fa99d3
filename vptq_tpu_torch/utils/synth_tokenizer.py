"""Minimal byte-level tokenizer directory for tests and demos.

The port's copy of ``vptq_tpu/utils/synth_tokenizer.py``: a byte-level
vocabulary (ids 0-2 ``<pad>``, ``<s>``, ``</s>``; the 256 bytes from id
3 on, in the order of the ``ByteLevel`` alphabet) with a trivial chat
template, saved in HF layout so that ``AutoTokenizer.from_pretrained``
reads it. ``tokenizers`` and ``transformers`` are imported only when a
directory is written; :class:`ByteTokenizer` reads and writes the same
ids without them (the card's machine has neither).
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["ByteTokenizer", "CHAT_TEMPLATE", "write_byte_tokenizer"]

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


def _byte_level_bytes() -> list:
    """The byte of each of the ids 3..258 of :func:`write_byte_tokenizer`'s
    directory: its vocabulary lists the ``ByteLevel`` alphabet (GPT-2's
    byte-to-character table) sorted by character."""
    printable = [*range(ord("!"), ord("~") + 1),
                 *range(ord("¡"), ord("¬") + 1),
                 *range(ord("®"), ord("ÿ") + 1)]
    char = {b: b for b in printable}
    for n, b in enumerate(b for b in range(256) if b not in char):
        char[b] = 256 + n
    return sorted(range(256), key=char.__getitem__)


class ByteTokenizer:
    """The byte tokenizer of :func:`write_byte_tokenizer`'s directory
    without ``transformers``: ids 0-2
    ``<pad>``, ``<s>``, ``</s>`` (the EOS), each UTF-8 byte of the text at
    its id from 3 on, no special tokens added, its chat template. Ids from
    259 on decode to nothing."""

    eos_token_id = 2

    def __init__(self):
        self.byte_of = _byte_level_bytes()
        self.id_of = {b: 3 + i for i, b in enumerate(self.byte_of)}

    def encode(self, text: str) -> list:
        return [self.id_of[b] for b in text.encode("utf-8")]

    def __call__(self, text, return_tensors=None, add_special_tokens=True):
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens=True) -> str:
        """The text of ``ids``, the specials skipped (as the entry points
        ask)."""
        return bytes(self.byte_of[i - 3] for i in ids if 3 <= i < 259
                     ).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, add_generation_prompt=True):
        text = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return self.encode(
            text + ("assistant:" if add_generation_prompt else ""))
