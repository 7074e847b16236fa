"""Synthetic data pipelines (a copy of ``repro/data/pipeline.py``: the
same seed gives the same numpy batches, byte for byte).

No LLaVA-1.5 data is available offline (DESIGN.md SS3), so each modality
gets a *learnable* synthetic task whose difficulty is sensitive to boundary
-activation fidelity — which is exactly what the Table-3 benchmark needs to
rank compression methods:

* text: affine-Markov next-token stream  t_{i+1} = (a t_i + b) mod V with
  occasional resets — learnable by a tiny LM, requires propagating state.
* vlm (synthetic VQA): images are class prototypes + noise in vision space;
  the answer tokens deterministically encode the class id.  Getting the
  answer right requires the class to survive the compressed cut — the
  quantization bottleneck is on the information path, as in real VQA.
* audio: per-codebook cyclic progressions with codebook-coupled phase.

Batches are numpy dicts; the train step (``train/loop.py``) moves them to
its parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.train.losses import IGNORE


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 8
    seq_len: int = 64
    seed: int = 0
    n_classes: int = 16  # vlm task
    answer_len: int = 4


class SyntheticPipeline:
    def __init__(self, arch: ArchConfig, pcfg: PipelineConfig):
        self.arch = arch
        self.pcfg = pcfg
        self.rng = np.random.default_rng(pcfg.seed)
        if arch.modality == "vlm":
            self.prototypes = self.rng.normal(
                size=(pcfg.n_classes, arch.d_vision)).astype(np.float32)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        a = self.arch
        if a.modality == "vlm":
            return self._vqa_batch()
        if a.modality == "audio":
            return self._audio_batch()
        return self._text_batch()

    # ------------------------------------------------------------------
    def _text_batch(self) -> Dict[str, np.ndarray]:
        p, a = self.pcfg, self.arch
        v = a.vocab_size
        # fixed affine map for the whole stream: next-token is a learnable
        # (memorizable) function of the current token
        mult, add = 5, 17
        t0 = self.rng.integers(0, v, size=(p.batch_size, 1))
        toks = [t0]
        for _ in range(p.seq_len - 1):
            toks.append((toks[-1] * mult + add) % v)
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((p.batch_size, 1), IGNORE)],
            axis=1).astype(np.int32)
        return dict(tokens=tokens, labels=labels,
                    positions=np.arange(p.seq_len, dtype=np.int32))

    def _vqa_batch(self) -> Dict[str, np.ndarray]:
        p, a = self.pcfg, self.arch
        b = p.batch_size
        cls = self.rng.integers(0, p.n_classes, size=(b,))
        img = (self.prototypes[cls][:, None, :] +
               0.3 * self.rng.normal(size=(b, a.n_image_tokens, a.d_vision))
               ).astype(np.float32)
        text_len = p.seq_len
        tokens = self.rng.integers(0, a.vocab_size,
                                   size=(b, text_len)).astype(np.int32)
        # answer: last `answer_len` positions encode the class id
        ans = np.stack([(cls + j) % min(a.vocab_size, 256)
                        for j in range(p.answer_len)], axis=1)
        tokens[:, -p.answer_len:] = ans
        full_len = a.n_image_tokens + text_len
        labels = np.full((b, full_len), IGNORE, np.int64)
        # predict answer tokens (teacher forcing: label at pos i-1 is tok i)
        start = full_len - p.answer_len
        labels[:, start - 1:full_len - 1] = ans
        return dict(image_embeds=img, tokens=tokens,
                    labels=labels.astype(np.int32),
                    positions=np.arange(full_len, dtype=np.int32))

    def _audio_batch(self) -> Dict[str, np.ndarray]:
        p, a = self.pcfg, self.arch
        b, k, v = p.batch_size, a.n_codebooks, a.vocab_size
        phase = self.rng.integers(0, v, size=(b, k, 1))
        step = np.arange(p.seq_len)[None, None, :]
        stride = np.arange(1, k + 1)[None, :, None]
        codes = ((phase + stride * step) % v).astype(np.int32)
        labels = np.concatenate(
            [codes[:, :, 1:], np.full((b, k, 1), IGNORE)],
            axis=2).astype(np.int32)
        return dict(codes=codes, labels_codes=labels,
                    positions=np.arange(p.seq_len, dtype=np.int32))


def make_pipeline(arch: ArchConfig, batch_size: int, seq_len: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    if arch.modality == "vlm":
        seq_len = max(8, seq_len - arch.n_image_tokens)
    return iter(SyntheticPipeline(
        arch, PipelineConfig(batch_size=batch_size, seq_len=seq_len,
                             seed=seed)))
