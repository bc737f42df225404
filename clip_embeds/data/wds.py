"""Sharded tar streaming pipeline (webdataset-equivalent, stdlib tarfile).

Reference: open_clip_train/data.py — brace-expanded shard lists
(expand_urls via webdataset, data.py:379+), deterministic epoch-seeded shard
shuffle (detshuffle2, :349-378), weighted shard resampling (ResampledShards2,
:381-432), corrupt-sample tolerance (log_and_continue :287-290 +
group_by_keys_nothrow :293-318), worker shard splitting, and sample shuffle
buffers (2000/5000). Workers here are threads feeding a queue — one process
drives the device, so there is no torch DataLoader process pool to replicate.
"""

from __future__ import annotations

import io
import itertools
import logging
import os
import random
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def expand_urls(urls: str) -> List[str]:
    """Brace expansion: 'shard-{000..002}.tar' -> 3 paths (wds syntax)."""
    if isinstance(urls, (list, tuple)):
        return list(urls)
    out = [urls]
    pattern = re.compile(r"\{(\d+)\.\.(\d+)\}")
    while True:
        expanded = []
        changed = False
        for u in out:
            m = pattern.search(u)
            if not m:
                expanded.append(u)
                continue
            changed = True
            lo, hi = m.group(1), m.group(2)
            width = len(lo)
            for i in range(int(lo), int(hi) + 1):
                expanded.append(u[: m.start()] + str(i).zfill(width) + u[m.end():])
        out = expanded
        if not changed:
            return out


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix; skip corrupt samples (nothrow)."""
    try:
        with tarfile.open(path) as tf:
            current_key = None
            sample: Dict[str, bytes] = {}
            for member in tf:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                if "." not in base:
                    continue
                key, ext = base.split(".", 1)
                if current_key is not None and key != current_key:
                    if sample:
                        yield dict(sample, __key__=current_key.encode())
                    sample = {}
                current_key = key
                try:
                    sample[ext] = tf.extractfile(member).read()
                except Exception as exc:  # corrupt member: drop sample
                    logging.warning("skipping corrupt member %s: %s",
                                    member.name, exc)
                    sample = {}
                    current_key = None
            if sample and current_key is not None:
                yield dict(sample, __key__=current_key.encode())
    except Exception as exc:  # corrupt shard: continue (log_and_continue)
        logging.warning("skipping corrupt shard %s: %s", path, exc)


class ShardedTarDataset:
    """Deterministically shuffled / resampled shard streaming."""

    def __init__(
        self,
        urls: str,
        decode: Optional[Callable[[Dict[str, bytes]], Optional[dict]]] = None,
        shuffle_shards: bool = True,
        resampled: bool = False,
        weights: Optional[Sequence[float]] = None,
        sample_shuffle_size: int = 0,
        seed: int = 0,
    ):
        self.shards = expand_urls(urls)
        self.decode = decode
        self.shuffle_shards = shuffle_shards
        self.resampled = resampled
        self.weights = list(weights) if weights is not None else None
        if self.weights is not None:
            assert len(self.weights) == len(self.shards)
        self.sample_shuffle_size = sample_shuffle_size
        self.seed = seed

    def _shard_order(self, epoch: int) -> List[str]:
        rng = random.Random(self.seed + epoch)  # detshuffle2 semantics
        if self.resampled:
            return rng.choices(
                self.shards, weights=self.weights, k=len(self.shards)
            )
        order = list(self.shards)
        if self.shuffle_shards:
            rng.shuffle(order)
        return order

    def __call__(self, epoch: int = 0, num_workers: int = 4) -> Iterator[dict]:
        shards = self._shard_order(epoch)
        rng = random.Random(self.seed * 7919 + epoch)

        def read(shard):
            return list(iter_tar_samples(shard))

        if num_workers > 1:
            with ThreadPoolExecutor(num_workers) as pool:
                streams = pool.map(read, shards)
                samples = itertools.chain.from_iterable(streams)
                yield from self._postprocess(samples, rng)
        else:
            samples = itertools.chain.from_iterable(
                iter_tar_samples(s) for s in shards
            )
            yield from self._postprocess(samples, rng)

    def _postprocess(self, samples, rng) -> Iterator[dict]:
        if self.sample_shuffle_size > 1:
            samples = _buffered_shuffle(samples, self.sample_shuffle_size, rng)
        for raw in samples:
            item = self.decode(raw) if self.decode is not None else raw
            if item is not None:
                yield item


def _buffered_shuffle(iterator, bufsize: int, rng) -> Iterator:
    buf: List = []
    for item in iterator:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        idx = rng.randrange(bufsize)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def decode_image_text(raw: Dict[str, bytes]) -> Optional[dict]:
    """Standard img+txt decode (jpg/png/webp + txt), dropping bad samples."""
    from PIL import Image

    image_key = next(
        (k for k in ("jpg", "jpeg", "png", "webp") if k in raw), None
    )
    if image_key is None or "txt" not in raw:
        return None
    try:
        image = Image.open(io.BytesIO(raw[image_key])).convert("RGB")
        return {"image": image, "text": raw["txt"].decode("utf-8")}
    except Exception as exc:
        logging.warning("dropping undecodable sample: %s", exc)
        return None


def decode_raw_image_text(raw: Dict[str, bytes]) -> Optional[dict]:
    """Validate keys but KEEP the encoded image bytes.

    Pairs with wds_batches' native mode: decode is deferred to batch time so
    the C++ pipeline (native/decode.cpp) can decode+preprocess the whole
    batch GIL-free instead of one PIL image per sample.
    """
    image_key = next(
        (k for k in ("jpg", "jpeg", "png", "webp") if k in raw), None
    )
    if image_key is None or "txt" not in raw:
        return None
    try:
        return {"image_bytes": raw[image_key],
                "text": raw["txt"].decode("utf-8")}
    except Exception as exc:
        logging.warning("dropping undecodable sample: %s", exc)
        return None


def wds_batches(
    dataset: ShardedTarDataset,
    batch_size: int,
    image_size: int = 224,
    tokenizer=None,
    epoch: int = 0,
    preprocess_variant: str = "clip",
    drop_last: bool = True,
    train_transform=None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Decode -> preprocess -> tokenize -> fixed-size numpy batches.

    Samples carrying PIL images (decode_image_text) go through the per-image
    preprocess path; samples carrying encoded bytes (decode_raw_image_text)
    are decoded+preprocessed per batch by the native C++ pipeline with
    per-slot PIL fallback — undecodable samples drop with log_and_continue
    semantics and the batch refills from later samples.

    ``train_transform`` (image.transform ``(image, rng) -> [S,S,3]``) routes
    every sample through the randomized train pipeline (RandomResizedCrop +
    aug_cfg) with a per-(seed, epoch, stream-position) Philox rng; the
    deterministic native geometry cannot express a random crop, so this path
    decodes per sample.
    """
    from ..image.preprocess import preprocess_batch
    from ..text.tokenizer import get_tokenizer

    from ..image.loader import variant_kwargs

    tokenizer = tokenizer or get_tokenizer()
    native_kwargs = variant_kwargs(preprocess_variant)
    if train_transform is not None:
        import io

        from PIL import Image

        from ..image.transform import sample_rng

        counter = 0

        def train_rows(item):
            nonlocal counter
            rng = sample_rng(seed, epoch, counter)
            counter += 1
            img = item.get("image")
            if img is None:
                try:
                    img = Image.open(io.BytesIO(item["image_bytes"]))
                    img.load()
                except Exception as exc:
                    logging.warning("dropping undecodable sample: %s", exc)
                    return
            rows.append(train_transform(img, rng))
            texts.append(item["text"])

    pending: List[dict] = []   # raw-bytes samples awaiting batch decode
    rows: List[np.ndarray] = []
    texts: List[str] = []

    def decode_pending():
        from ..image.loader import decode_preprocess_batch

        nonlocal pending
        batch, ok = decode_preprocess_batch(
            [p["image_bytes"] for p in pending], image_size, **native_kwargs
        )
        for p, arr, good in zip(pending, batch, ok):
            if not good:
                logging.warning("dropping undecodable sample (native batch)")
                continue
            rows.append(arr)
            texts.append(p["text"])
        pending = []

    def emit():
        out = {
            "images": np.stack(rows[:batch_size]),
            "texts": tokenizer(texts[:batch_size]),
        }
        del rows[:batch_size], texts[:batch_size]
        return out

    for item in dataset(epoch):
        if train_transform is not None:
            train_rows(item)
        elif "image_bytes" in item:
            if native_kwargs is None:
                raise ValueError(
                    f"preprocess variant {preprocess_variant!r} has no native "
                    "batch-decode geometry; use decode_image_text instead"
                )
            pending.append(item)
            if len(pending) == batch_size:
                decode_pending()
        else:
            rows.append(
                preprocess_batch([item["image"]], image_size,
                                 preprocess_variant)[0]
            )
            texts.append(item["text"])
        while len(rows) >= batch_size:
            yield emit()
    if pending:
        decode_pending()
    while len(rows) >= batch_size:
        yield emit()
    if rows and not drop_last:
        yield {"images": np.stack(rows), "texts": tokenizer(texts)}
