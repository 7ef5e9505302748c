"""Byte-level tokenizer (vocab 256 + specials) for the examples/tests."""

from __future__ import annotations

from typing import List, Sequence



PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id, bos_id, eos_id = PAD_ID, BOS_ID, EOS_ID

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        raw = bytes(i for i in ids if i < 256)
        return raw.decode("utf-8", errors="replace")
