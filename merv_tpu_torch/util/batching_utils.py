"""Modality-aware, length-grouped batch sampling (counterpart of
``merv_tpu/util/batching_utils.py``, kept as a copy: the port imports nothing
of ``merv_tpu``).

:class:`SplitModalitySampler` (finetune): every global batch is
single-modality; within a batch, examples are sorted by length and
re-bucketed so each replica gets a contiguous, length-homogeneous sub-batch;
the longest batch is swapped to index 0 for early OOM. :class:`EpochShardSampler`
(align): a seeded per-epoch permutation. Both draw from ``torch.Generator`` +
``torch.randperm`` exactly as ``merv_tpu`` does, so index streams are
identical for a given (seed, epoch). Without ``num_replicas`` / ``rank`` one
replica is assumed (the port trains on one card).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


class SplitModalitySampler:
    def __init__(
        self,
        dataset,
        modality_lengths: List[Tuple[bool, int]],
        global_batch_size: int,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        num_replicas = 1 if num_replicas is None else num_replicas
        rank = 0 if rank is None else rank
        self.num_replicas, self.rank = num_replicas, rank
        self.seed, self.epoch = seed, 0

        self.dataset, self.modality_lengths, self.drop_last = dataset, modality_lengths, drop_last
        self.global_batch_size = global_batch_size

        assert not self.drop_last, "SplitModalitySampler must set `drop_last = False`!"
        self.total_size = math.ceil(len(self.dataset) / self.global_batch_size) * self.global_batch_size
        self.num_samples = self.total_size // self.num_replicas

    @staticmethod
    def reindex_batch(batch_idxs: List[int], idx2lengths: List[int], n_buckets: int) -> List[List[int]]:
        """Greedy shortest-bucket assignment (reference batching_utils.py:49-68)."""
        assert len(batch_idxs) % n_buckets == 0, "Batch length is not divisible by `num_replicas`!"
        n_examples_per_bucket = len(batch_idxs) // n_buckets
        bucket_indices: List[List[int]] = [[] for _ in range(n_buckets)]
        bucket_lengths = [0.0 for _ in range(n_buckets)]

        for idx in batch_idxs:
            shortest = bucket_lengths.index(min(bucket_lengths))
            bucket_indices[shortest].append(idx)
            bucket_lengths[shortest] += idx2lengths[idx]
            if len(bucket_indices[shortest]) == n_examples_per_bucket:
                bucket_lengths[shortest] = float("inf")
        return bucket_indices

    def get_modality_and_length_grouped_indices(self, generator) -> List[int]:
        multimodal_indices, multimodal_lengths = zip(
            *[(i, length) for i, (is_mm, length) in enumerate(self.modality_lengths) if is_mm]
        )
        unimodal_split = [(i, length) for i, (is_mm, length) in enumerate(self.modality_lengths) if not is_mm]
        if len(unimodal_split) == 0:
            unimodal_indices: Tuple[int, ...] = ()
            unimodal_lengths: Tuple[int, ...] = ()
        else:
            unimodal_indices, unimodal_lengths = zip(*unimodal_split)

        mm_shuffled_idxs = torch.randperm(len(multimodal_indices), generator=generator)
        uni_shuffled_idxs = torch.randperm(len(unimodal_indices), generator=generator)

        g_bsz = self.global_batch_size
        mm_batch_idxs = [mm_shuffled_idxs[i : i + g_bsz].tolist() for i in range(0, len(mm_shuffled_idxs), g_bsz)]
        uni_batch_idxs = [uni_shuffled_idxs[i : i + g_bsz].tolist() for i in range(0, len(uni_shuffled_idxs), g_bsz)]

        # pad the ragged tail by stealing from the first batch (reference :100-107)
        if len(mm_batch_idxs[-1]) < g_bsz:
            mm_batch_idxs[-1].extend(mm_batch_idxs[0][: g_bsz - len(mm_batch_idxs[-1])])
        if len(uni_batch_idxs) > 0 and len(uni_batch_idxs[-1]) < g_bsz:
            uni_batch_idxs[-1].extend(uni_batch_idxs[0][: g_bsz - len(uni_batch_idxs[-1])])

        mm_sorted = [sorted(b, key=lambda i: multimodal_lengths[i], reverse=True) for b in mm_batch_idxs]
        uni_sorted = [sorted(b, key=lambda i: unimodal_lengths[i], reverse=True) for b in uni_batch_idxs]

        mm_bucketed = [self.reindex_batch(b, multimodal_lengths, self.num_replicas) for b in mm_sorted]
        uni_bucketed = [self.reindex_batch(b, unimodal_lengths, self.num_replicas) for b in uni_sorted]

        mm_flat = [i for batch in mm_bucketed for bucket in batch for i in bucket]
        mm_reindexed = [multimodal_indices[i] for i in mm_flat]
        mm_batches = [mm_reindexed[i : i + g_bsz] for i in range(0, len(mm_reindexed), g_bsz)]

        uni_flat = [i for batch in uni_bucketed for bucket in batch for i in bucket]
        uni_reindexed = [unimodal_indices[i] for i in uni_flat]
        uni_batches = [uni_reindexed[i : i + g_bsz] for i in range(0, len(uni_reindexed), g_bsz)]

        merged = mm_batches + uni_batches
        merge_idxs = torch.randperm(len(merged), generator=generator)
        all_batches = [merged[i] for i in merge_idxs]

        # longest batch first for early OOM (reference :172-180; 24*24 visual-token proxy)
        all_lengths = [length + (24 * 24 if is_mm else 0) for is_mm, length in self.modality_lengths]
        batch_maxes = [max(all_lengths[i] for i in batch) for batch in all_batches]
        longest = int(np.argmax(batch_maxes))
        all_batches[0], all_batches[longest] = all_batches[longest], all_batches[0]

        return [i for batch in all_batches for i in batch]

    def __iter__(self) -> Iterator[int]:
        g = torch.Generator()
        g.manual_seed(self.seed + self.epoch)
        indices = self.get_modality_and_length_grouped_indices(g)
        assert len(set(indices)) == len(self.modality_lengths) == len(self.dataset), "Oops!"
        assert (len(indices) % self.global_batch_size == 0) and (len(indices) % self.num_replicas) == 0, "Oops"

        per_replica_batch_size = self.global_batch_size // self.num_replicas
        arr = np.asarray(indices).reshape(-1, per_replica_batch_size)
        replica = arr[self.rank :: self.num_replicas]
        return iter(replica.flatten().tolist())

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch


class EpochShardSampler:
    """Plain shuffled epoch sampler, sharded across processes.

    The align-stage sampler: a seeded per-epoch permutation padded to a
    multiple of the world size, each process taking a strided slice.
    """

    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0, seed: int = 0, shuffle: bool = True) -> None:
        self.dataset, self.num_replicas, self.rank = dataset, num_replicas, rank
        self.seed, self.epoch, self.shuffle = seed, 0, shuffle
        self.num_samples = math.ceil(len(dataset) / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            indices = torch.randperm(len(self.dataset), generator=g).tolist()
        else:
            indices = list(range(len(self.dataset)))
        indices += indices[: self.total_size - len(indices)]  # pad to multiple
        return iter(indices[self.rank :: self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
