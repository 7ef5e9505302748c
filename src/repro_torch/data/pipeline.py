"""Synthetic LM data pipeline: corpus synthesis, packing, batching.

A copy of ``repro.data.pipeline`` (numpy only, so it gives the same
arrays from the same seeds): the serve CLI feeds ``stub_frames`` /
``stub_image_embeds`` to the encoder-decoder and cross-attention archs
as each request's ``extra`` inputs.

Deterministic, dependency-free stand-in for a real corpus: sentences
are drawn from a small grammar with a seeded RNG, then byte-tokenized
and *packed* into fixed-length rows (documents separated by EOS, no
padding waste) — the standard LM pretraining layout.  Batches come out
as numpy so the launcher can shard them onto the mesh
(batch axis -> ("pod","data")).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from .tokenizer import ByteTokenizer


_SUBJECTS = ["the scheduler", "a numa node", "the tensor", "one thread",
             "the memory pool", "a weight shard", "the kv cache",
             "the gather op", "this barrier", "the decode loop"]
_VERBS = ["binds", "streams", "partitions", "synchronizes", "allocates",
          "scatters", "gathers", "prefetches", "saturates", "overlaps"]
_OBJECTS = ["local memory", "remote pages", "the activation buffer",
            "attention heads", "the expert weights", "both subgraphs",
            "every cacheline", "the ring buffer", "the mlp block",
            "its thread group"]


def synth_corpus(n_docs: int, seed: int = 0) -> List[str]:
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n_sent = int(rng.integers(1, 6))
        sents = []
        for _ in range(n_sent):
            s = (f"{rng.choice(_SUBJECTS)} {rng.choice(_VERBS)} "
                 f"{rng.choice(_OBJECTS)}")
            sents.append(s)
        docs.append(". ".join(sents) + ".")
    return docs


class PackedLMDataset:
    """Packs tokenized documents into (seq_len,) rows, loops forever."""

    def __init__(self, seq_len: int, *, n_docs: int = 2000, seed: int = 0,
                 vocab_size: Optional[int] = None) -> None:
        tok = ByteTokenizer()
        stream: List[int] = []
        for doc in synth_corpus(n_docs, seed):
            stream.extend(tok.encode(doc, bos=True, eos=True))
        self.tokens = np.asarray(stream, np.int32)
        if vocab_size is not None:
            self.tokens = self.tokens % vocab_size
        self.seq_len = seq_len
        self.n_rows = len(self.tokens) // (seq_len + 1)
        if self.n_rows < 1:
            raise ValueError("corpus too small for seq_len")

    def row(self, i: int) -> Dict[str, np.ndarray]:
        i = i % self.n_rows
        s = self.seq_len
        chunk = self.tokens[i * (s + 1):(i + 1) * (s + 1)]
        return {"tokens": chunk[:-1], "labels": chunk[1:]}

    def batches(self, batch_size: int, *, seed: int = 0,
                extra_fn=None) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        for step in itertools.count():
            idx = rng.integers(0, self.n_rows, size=batch_size)
            rows = [self.row(int(i)) for i in idx]
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            if extra_fn is not None:
                batch.update(extra_fn(step, batch_size))
            yield batch


def stub_frames(batch_size: int, n_frames: int, d_model: int,
                seed: int = 0) -> np.ndarray:
    """Stub audio frame embeddings (the conv frontend carve-out)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (batch_size, n_frames, d_model)).astype(
        np.float32)


def stub_image_embeds(batch_size: int, n_tokens: int, d_model: int,
                      seed: int = 0) -> np.ndarray:
    """Stub vision-encoder patch embeddings (the ViT carve-out)."""
    rng = np.random.default_rng(seed + 1)
    return rng.normal(0, 1, (batch_size, n_tokens, d_model)).astype(
        np.float32)
