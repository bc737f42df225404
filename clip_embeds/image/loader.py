"""Native batched image loading: bytes -> normalized float32 batch.

The reference decodes every image with PIL inside Python dataloader workers
(open_clip_train/data.py wds decode; t2v_metrics ScoreModel image loader;
PACL utils.py) — at device serving rates the GIL-bound decode
becomes the end-to-end bottleneck. This module drives the C++ pipeline in
native/decode.cpp: JPEG/PNG/WebP decode, Pillow-compatible antialiased
shortest-edge resize, center crop, and fused normalize — threaded across the
batch with zero Python in the loop, writing straight into one [N,S,S,3]
float32 buffer ready for device_put.

Exotic inputs the C++ path refuses (CMYK JPEG, alpha PNG/WebP, animated
WebP, GIF/BMP/TIFF) are filled per-slot through the PIL fallback, so the
output is always complete and PIL-faithful.
"""

from __future__ import annotations

import ctypes
import io
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


def variant_kwargs(variant: str) -> Optional[dict]:
    """Geometry/stats of a preprocess variant for the native batch decoder
    (must match image/preprocess.py preprocess_{clip,siglip,pacl}); None for
    variants the C++ geometry doesn't cover (e.g. llava expand2square)."""
    from ..core.constants import IMAGENET_MEAN, IMAGENET_STD

    return {
        "clip": dict(shortest_edge=True, bicubic=True,
                     mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD),
        "siglip": dict(shortest_edge=False, bicubic=True,
                       mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        "pacl": dict(shortest_edge=False, bicubic=False,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD),
    }.get(variant)


def native_decode_preprocess(
    blobs: Sequence[bytes],
    image_size: int,
    mean: Sequence[float] = OPENAI_DATASET_MEAN,
    std: Sequence[float] = OPENAI_DATASET_STD,
    bicubic: bool = True,
    shortest_edge: bool = True,
    fast_jpeg: bool = False,
    num_threads: int = 0,
    out: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode+preprocess encoded images on the C++ fast path.

    Returns (batch [N,S,S,3] float32, ok [N] bool) or None when the native
    library is unavailable. Slots with ok=False were not written (exotic
    format) — use :func:`decode_preprocess_batch` for automatic fallback.
    """
    from ..native.build import load_library

    lib = load_library()
    if lib is None or not hasattr(lib, "decode_preprocess_batch"):
        return None
    n = len(blobs)
    if out is None:
        out = np.empty((n, image_size, image_size, 3), np.float32)
    else:
        assert out.shape == (n, image_size, image_size, 3)
        assert out.dtype == np.float32 and out.flags.c_contiguous
    if n == 0:
        return out, np.zeros((0,), bool)

    # Keep byte objects alive and build the pointer/length tables.
    bufs = (ctypes.c_void_p * n)()
    lens = np.empty((n,), np.uintp)
    for i, b in enumerate(blobs):
        bufs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        lens[i] = len(b)
    ok = np.zeros((n,), np.uint8)
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.decode_preprocess_batch(
        bufs, lens.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), image_size,
        mean_arr.ctypes.data_as(ctypes.c_void_p),
        std_arr.ctypes.data_as(ctypes.c_void_p),
        1 if bicubic else 0, 1 if shortest_edge else 0,
        1 if fast_jpeg else 0, num_threads,
        ok.ctypes.data_as(ctypes.c_void_p),
    )
    return out, ok.astype(bool)


def _pil_decode_preprocess(
    blob: bytes,
    image_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    shortest_edge: bool,
    bicubic: bool = True,
) -> Optional[np.ndarray]:
    """PIL fallback for one sample; None if the bytes don't decode at all."""
    from PIL import Image

    from .preprocess import _center_crop, _normalize, _resize_shortest

    try:
        img = Image.open(io.BytesIO(blob)).convert("RGB")
        if shortest_edge:
            img = _center_crop(_resize_shortest(img, image_size), image_size)
        else:
            resample = Image.BICUBIC if bicubic else Image.BILINEAR
            img = img.resize((image_size, image_size), resample)
        return _normalize(np.asarray(img), mean, std)
    except Exception:
        return None


def decode_preprocess_batch(
    blobs: Sequence[bytes],
    image_size: int,
    mean: Sequence[float] = OPENAI_DATASET_MEAN,
    std: Sequence[float] = OPENAI_DATASET_STD,
    bicubic: bool = True,
    shortest_edge: bool = True,
    fast_jpeg: bool = False,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encoded bytes -> ([N,S,S,3] float32 batch, valid [N] bool).

    Native C++ fast path with per-slot PIL fallback; valid=False only for
    samples neither path could decode (corrupt bytes) — their slots are
    zero-filled so the batch shape stays static (callers drop or mask them,
    mirroring the reference's log_and_continue tolerance).
    """
    n = len(blobs)
    res = native_decode_preprocess(
        blobs, image_size, mean, std, bicubic, shortest_edge, fast_jpeg,
        num_threads,
    )
    if res is None:
        out = np.zeros((n, image_size, image_size, 3), np.float32)
        ok = np.zeros((n,), bool)
    else:
        out, ok = res
    if not ok.all():
        for i in np.flatnonzero(~ok):
            arr = _pil_decode_preprocess(
                blobs[i], image_size, mean, std, shortest_edge, bicubic
            )
            if arr is not None:
                out[i] = arr
                ok[i] = True
            else:
                out[i] = 0.0
    return out, ok


class PrefetchLoader:
    """Background-threaded batch loader over a list of image files.

    While the device runs batch i, a worker thread has already read and
    native-decoded batch i+1 (bounded queue = double buffering). Replaces
    the reference's torch DataLoader worker processes for the serving path.
    """

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        image_size: int,
        mean: Sequence[float] = OPENAI_DATASET_MEAN,
        std: Sequence[float] = OPENAI_DATASET_STD,
        shortest_edge: bool = True,
        fast_jpeg: bool = False,
        num_threads: int = 0,
        prefetch: int = 2,
    ) -> None:
        self.paths = list(paths)
        self.batch_size = batch_size
        self.image_size = image_size
        self.mean, self.std = mean, std
        self.shortest_edge = shortest_edge
        self.fast_jpeg = fast_jpeg
        self.num_threads = num_threads
        self.prefetch = max(1, prefetch)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            """Bounded put that yields to a consumer abandoning iteration —
            never blocks forever holding a decoded batch."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for start in range(0, len(self.paths), self.batch_size):
                    if stop.is_set():
                        return
                    chunk = self.paths[start : start + self.batch_size]
                    blobs = []
                    for p in chunk:
                        try:
                            with open(p, "rb") as fh:
                                blobs.append(fh.read())
                        except OSError:
                            blobs.append(b"")
                    batch, ok = decode_preprocess_batch(
                        blobs, self.image_size, self.mean, self.std,
                        shortest_edge=self.shortest_edge,
                        fast_jpeg=self.fast_jpeg,
                        num_threads=self.num_threads,
                    )
                    if not put_or_abort((chunk, batch, ok)):
                        return
            finally:
                put_or_abort(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # Drain so the producer's blocked put() can observe stop.
            while True:
                try:
                    if q.get_nowait() is None:
                        break
                except Exception:
                    break
