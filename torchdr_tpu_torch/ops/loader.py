"""Batch feeds for the streaming paths (counterpart of ``torchdr_tpu/ops/loader.py``).

:class:`BatchSource` gives the batch-built IVF index and the segmented
search a uniform multi-pass view over

- a list or tuple of arrays (in memory: passes are free),
- a one-shot generator (buffered on the first pass: it cannot be replayed),
- a torch ``DataLoader`` or any other re-iterable (replayed on each pass,
  so the dataset is never held in host memory by this package),
- a zero-argument callable that returns a fresh iterator on each call (the
  streaming form for datasets beyond host memory).

Batches may be numpy arrays or tensors, optionally as ``(data, target)``
tuples; every pass yields C-contiguous float32 numpy arrays. Several passes
need one fixed batch order, so DataLoader-like sources are checked against
shuffling samplers (:func:`validate_deterministic_loader`) and the counting
pass is cached per loader object (:func:`get_loader_metadata`).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = [
    "BatchSource",
    "get_loader_metadata",
    "validate_deterministic_loader",
]

# {id(loader): metadata}, so repeated builds and searches over one loader
# object skip the counting pass. The keyed object is pinned, so the id of a
# collected loader cannot be reused to serve another loader's metadata.
_LOADER_METADATA_CACHE: dict = {}
_LOADER_CACHE_PINS: dict = {}


def get_loader_metadata(loader):
    """Cached ``{n_samples, n_features, batch_sizes}`` of a loader that a
    :class:`BatchSource` has counted, else None."""
    return _LOADER_METADATA_CACHE.get(id(loader))


def _is_deterministic_sampler(sampler) -> bool:
    from torch.utils.data import BatchSampler, RandomSampler, SequentialSampler

    if isinstance(sampler, RandomSampler):
        return False
    if isinstance(sampler, SequentialSampler):
        return True
    if isinstance(sampler, BatchSampler):
        return _is_deterministic_sampler(sampler.sampler)
    if hasattr(sampler, "shuffle"):
        return not sampler.shuffle
    return True


def validate_deterministic_loader(loader) -> None:
    """Reject a loader whose order changes between passes.

    The batch-built index reads its feed several times (count, training
    sample, assignment, write) and names rows by their place in the feed,
    so a shuffling sampler would silently corrupt the kNN ids. A loader
    without a sampler only warns.
    """
    if not hasattr(loader, "sampler"):
        warnings.warn(
            "[TorchDR-Torch] Could not verify the loader iterates "
            "deterministically. Multi-pass streaming requires a stable "
            "batch order; ensure shuffle=False."
        )
        return
    if not _is_deterministic_sampler(loader.sampler):
        raise ValueError(
            "[TorchDR-Torch] ERROR : DataLoader must have shuffle=False for "
            "deterministic multi-pass iteration. Current sampler: "
            f"{type(loader.sampler).__name__}. kNN indices would be "
            "incorrect with shuffled batches."
        )


def _normalize_batch(batch) -> np.ndarray:
    """A batch as a C-contiguous float32 (rows, features) numpy array: the
    first item of a tuple, a tensor brought to the host."""
    if isinstance(batch, (list, tuple)):
        batch = batch[0]
    if hasattr(batch, "detach"):  # a tensor
        batch = batch.detach().cpu().numpy()
    out = np.ascontiguousarray(np.asarray(batch), dtype=np.float32)
    if out.ndim != 2:
        raise ValueError(
            "[TorchDR-Torch] ERROR : batches must be 2-d (rows, features); "
            f"got shape {out.shape}."
        )
    return out


class BatchSource:
    """Multi-pass view over a batch feed (see the module docstring).

    Every pass yields the same C-contiguous float32 numpy batches in the
    same order. :attr:`buffered` says whether a pass reads a buffer (array
    lists, one-shot generators) or replays the source (DataLoaders,
    re-iterables, factories), which holds one batch at a time.
    """

    def __init__(self, batches):
        if isinstance(batches, BatchSource):
            self._buffer = batches._buffer
            self._factory = batches._factory
            self._source = batches._source
            return
        self._buffer = None
        self._factory = None
        self._source = None
        if getattr(batches, "ndim", None) == 2:  # one array: one batch
            self._buffer = [_normalize_batch(batches)]
        elif callable(batches) and not hasattr(batches, "__iter__"):
            self._factory = batches
        elif hasattr(batches, "sampler") or hasattr(batches, "dataset"):
            # DataLoader-like: re-iterable, usable over several passes only
            # with a deterministic sampler
            validate_deterministic_loader(batches)
            self._source = batches
        elif isinstance(batches, (list, tuple)) or hasattr(batches, "__getitem__"):
            self._buffer = [_normalize_batch(b) for b in batches]
        else:
            it = iter(batches)
            if it is batches:  # one-shot generator: the only replay is a copy
                self._buffer = [_normalize_batch(b) for b in it]
            else:
                self._source = batches
        if self._buffer is not None and not self._buffer:
            raise ValueError("[TorchDR-Torch] ERROR : empty batch iterable.")

    @property
    def buffered(self) -> bool:
        return self._buffer is not None

    def __iter__(self):
        if self._buffer is not None:
            yield from self._buffer
            return
        src = self._factory() if self._factory is not None else self._source
        n = 0
        for batch in src:
            yield _normalize_batch(batch)
            n += 1
        if n == 0:
            raise ValueError("[TorchDR-Torch] ERROR : empty batch iterable.")

    def _cache_key(self):
        if self._source is not None:
            return id(self._source)
        if self._factory is not None:
            return id(self._factory)
        return None

    def metadata(self) -> dict:
        """``{n_samples, n_features, batch_sizes}`` of the feed: free for a
        buffer, one counting pass for a replayed source, cached per loader
        or factory object."""
        if self._buffer is not None:
            sizes = [b.shape[0] for b in self._buffer]
            return {
                "n_samples": int(sum(sizes)),
                "n_features": int(self._buffer[0].shape[1]),
                "batch_sizes": sizes,
            }
        key = self._cache_key()
        cached = _LOADER_METADATA_CACHE.get(key)
        if cached is not None:
            return cached
        sizes: list = []
        d = None
        for b in self:
            sizes.append(b.shape[0])
            d = b.shape[1]
        meta = {"n_samples": int(sum(sizes)), "n_features": int(d), "batch_sizes": sizes}
        if key is not None:
            _LOADER_METADATA_CACHE[key] = meta
            _LOADER_CACHE_PINS[key] = self._source if self._source is not None else self._factory
        return meta

    def shape_hint(self) -> tuple:
        """(n_samples, n_features) as cheaply as possible: the buffer, the
        metadata cache, or ``len(source.dataset)`` and one batch; else a
        counting pass (which fills the cache)."""
        if self._buffer is not None:
            return (
                int(sum(b.shape[0] for b in self._buffer)),
                int(self._buffer[0].shape[1]),
            )
        cached = _LOADER_METADATA_CACHE.get(self._cache_key())
        if cached is not None:
            return cached["n_samples"], cached["n_features"]
        ds = getattr(self._source, "dataset", None)
        if ds is not None:
            try:
                n = len(ds)
            except TypeError:
                n = None
            if n is not None:
                for b in self:  # one batch for the width
                    return int(n), int(b.shape[1])
        meta = self.metadata()
        return meta["n_samples"], meta["n_features"]

    def slice(self, lo: int, hi: int) -> "BatchSource":
        """View over batches ``lo..hi`` (by batch index): a slice of the
        buffer, or a factory that replays the parent and skips the others."""
        out = BatchSource.__new__(BatchSource)
        out._factory = out._source = None
        if self._buffer is not None:
            out._buffer = self._buffer[lo:hi]
            return out
        parent = self

        def _gen():
            for i, b in enumerate(parent):
                if i >= hi:
                    break
                if i >= lo:
                    yield b

        out._buffer = None
        out._factory = _gen
        return out
