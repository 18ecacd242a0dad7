"""Minimal input pipelines: in-memory arrays and synthetic data (the port's
copy of ``cloud_tpu/training/data.py``; numpy only).

The streaming record pipeline is ``records.py``; this module covers the
in-memory workloads.

This pipeline speaks the **exactly-once resume contract**: each epoch's
shuffle order is a pure function of ``(seed, epoch)``, and
``state_dict()`` / ``load_state_dict()`` let a restored trainer
fast-forward the stream to ``{"epoch": E, "batches_consumed": B}`` — the
position its checkpoint recorded at the TRAINER boundary — and replay
exactly the batches an uninterrupted run would have seen from there.
The same seed gives the same batch order as the JAX package's class.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator

import numpy as np

from cloud_tpu_torch.monitoring import tracing

logger = logging.getLogger(__name__)


class ArrayDataset:
    """Re-iterable batched dataset over a dict of equal-length arrays.

    ``dataset()`` yields dict batches — the zero-arg-callable contract the
    Trainer expects (fresh iterator per epoch).

    Shuffle order is derived per epoch from ``(seed, epoch)`` (NOT from a
    persistent generator), so epoch E's order is reproducible without
    replaying epochs 0..E-1 — the property the exactly-once resume
    contract (``load_state_dict``) is built on.
    """

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Unequal array lengths: {lengths}")
        self.arrays = arrays
        self.n = next(iter(lengths.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_remainder = drop_remainder
        self._epoch = 0  # epochs issued so far (next __call__ uses this)
        self._skip = 0   # one-shot batch fast-forward for the next epoch
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")

    def state_dict(self) -> Dict[str, int]:
        """Reproducibility state (the trainer records the authoritative
        consumed-batch position; this is the dataset-side complement)."""
        return {"epoch": self._epoch, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        """Fast-forward: the next iterator produces epoch
        ``state["epoch"]`` with its first ``state["batches_consumed"]``
        batches skipped; later iterators continue with epoch+1, ...  The
        positions come from a checkpoint's trainer-boundary count, so
        batches a prefetcher pulled but the trainer never consumed are
        NOT skipped.  A ``seed`` in the state is ADOPTED: epoch/batch
        positions only name the right batches under the shuffle order
        they were recorded in, so a restarted script constructed with a
        different seed must replay the checkpoint's order (loudly), not
        silently duplicate/skip data under its own."""
        self._adopt_seed(state)
        self._epoch = int(state.get("epoch", 0))
        self._skip = int(state.get("batches_consumed", 0))

    def _adopt_seed(self, state: Dict) -> None:
        saved = state.get("seed")
        if saved is not None and int(saved) != self.seed:
            logger.warning(
                "restored iterator position was recorded under shuffle "
                "seed %s but this dataset was built with seed %d; "
                "adopting the checkpoint's seed so the replayed stream "
                "is the one the position points into", saved, self.seed,
            )
            self.seed = int(saved)

    def __call__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Epoch/skip are captured EAGERLY (not inside the generator), so
        # a prefetcher that creates the iterator but has not pulled yet
        # still advances the epoch counter deterministically.
        epoch = self._epoch
        self._epoch += 1
        skip, self._skip = self._skip, 0
        return self._iter_epoch(epoch, skip)

    def _iter_epoch(self, epoch: int, skip: int
                    ) -> Iterator[Dict[str, np.ndarray]]:
        with tracing.span("data/epoch_setup", shuffle=self.shuffle, n=self.n):
            order = np.arange(self.n)
            if self.shuffle:
                np.random.default_rng((self.seed, epoch)).shuffle(order)
        end = self.n - self.batch_size + 1 if self.drop_remainder else self.n
        for index, start in enumerate(range(0, end, self.batch_size)):
            if index < skip:
                continue
            # Span covers the gather/copy only, not the consumer's time
            # holding the generator suspended.
            with tracing.span("data/batch"):
                idx = order[start : start + self.batch_size]
                batch = {k: v[idx] for k, v in self.arrays.items()}
            yield batch

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size


def synthetic_tokens(
    *, vocab_size: int, seq_len: int, batch_size: int, num_batches: int,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic synthetic LM batches (benchmarks, smoke tests)."""
    rng = np.random.default_rng(seed)
    n = batch_size * num_batches
    tokens = rng.integers(0, vocab_size, size=(n, seq_len), dtype=np.int32)
    return ArrayDataset({"tokens": tokens}, batch_size)
