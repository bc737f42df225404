"""LLaVA-data (LCS-558K + DataMix-665K) loader with hard-text negatives.

Reference: the fork-added DataMixDataset
(open_clip/src/open_clip_train/data.py:29-134): filter samples without images,
pick a random answer turn as the caption, optionally derive a hard-negative
caption by phrase swapping, and batch with the hard texts appended after the B
originals. The torch collate produces a ragged B+H text batch
(data.py:122-134); here H is *static* (pad + validity mask) so the batch
shapes are XLA-stable — SURVEY.md §7 static-shape redesign.

Host-side decode runs in a thread pool; batches are contiguous numpy arrays
ready for device_put (no per-sample host work on the hot path).
"""

from __future__ import annotations

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..image.preprocess import preprocess_clip
from ..text.tokenizer import BPETokenizer, get_tokenizer
from .hard_negatives import HardNegativeAugmenter


class DataMixDataset:
    """Map-style access to LLaVA-format annotation lists."""

    def __init__(
        self,
        annotation_files: Sequence[str],
        image_roots: Dict[str, str],
        image_size: int = 336,
        tokenizer: Optional[BPETokenizer] = None,
        augmenter: Optional[HardNegativeAugmenter] = None,
        seed: int = 0,
        train_transform=None,
    ):
        """image_roots: {'lcs558k': dir, 'datamix665k': dir} — samples whose
        image path starts with '0' come from LCS-558K (reference
        data.py:100-104 path dispatch).

        ``train_transform``: an ``image.transform.image_transform(
        is_train=True, ...)`` callable ``(image, rng) -> [S,S,3]`` — the
        reference trains through RandomResizedCrop(+aug_cfg), not the eval
        transform (data.py:45 preprocess_train; transform.py:276-345)."""
        self.samples: List[dict] = []
        for path in annotation_files:
            with open(path) as fh:
                for sample in json.load(fh):
                    if "image" in sample:
                        self.samples.append(sample)
        self.image_roots = image_roots
        self.image_size = image_size
        self.tokenizer = tokenizer or get_tokenizer()
        self.augmenter = augmenter
        self.rng = random.Random(seed)
        self.train_transform = train_transform

    def __len__(self) -> int:
        return len(self.samples)

    def _image_path(self, sample: dict) -> str:
        root_key = "lcs558k" if sample["image"][0] == "0" else "datamix665k"
        return os.path.join(self.image_roots[root_key], sample["image"])

    def get(self, idx: int, transform_rng=None):
        """(pixels [S,S,3], caption str, hard_caption str|None)."""
        sample = self.samples[idx]
        if self.train_transform is not None:
            if transform_rng is None:
                transform_rng = np.random.default_rng(self.rng.getrandbits(63))
            pixels = self.train_transform(self._image_path(sample),
                                          transform_rng)
        else:
            pixels = preprocess_clip(self._image_path(sample), self.image_size)
        turns = sample["conversations"]
        i = self.rng.randint(0, len(turns) // 2 - 1)
        caption = turns[i * 2 + 1]["value"]
        hard = self.augmenter(caption) if self.augmenter is not None else None
        return pixels, caption, hard


def datamix_batches(
    dataset: DataMixDataset,
    batch_size: int,
    max_hard_per_batch: Optional[int] = None,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    drop_last: bool = True,
    epoch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield static-shape batches; hard texts padded to max_hard_per_batch.

    Augmentation randomness is per-(seed, epoch, sample-index) Philox streams
    (image.transform.sample_rng) so the threaded map stays deterministic and
    order-independent."""
    from ..image.transform import sample_rng

    if max_hard_per_batch is None:
        max_hard_per_batch = batch_size
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    tok = dataset.tokenizer
    ctx = tok.context_length

    def fetch(idx: int):
        return dataset.get(int(idx), sample_rng(seed, epoch, int(idx)))

    with ThreadPoolExecutor(num_workers) as pool:
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            items = list(pool.map(fetch, idxs))
            images = np.stack([it[0] for it in items])
            texts = tok([it[1] for it in items])
            hard_strings = [it[2] for it in items if it[2] is not None]
            hard_strings = hard_strings[:max_hard_per_batch]
            hard_texts = np.zeros((max_hard_per_batch, ctx), np.int32)
            hard_valid = np.zeros((max_hard_per_batch,), bool)
            if hard_strings:
                hard_texts[: len(hard_strings)] = tok(hard_strings)
                hard_valid[: len(hard_strings)] = True
            yield {
                "images": images,
                "texts": texts,
                "hard_texts": hard_texts,
                "hard_valid": hard_valid,
            }
