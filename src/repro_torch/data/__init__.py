"""Task streams — counterpart of ``repro/data``: the synthetic
generators, ``ragged`` (the padding contract of ragged streams),
``real`` (sequential MNIST and CIFAR-10 with checksummed download and
an offline surrogate, and the few-shot keyword stream) and ``pipeline``
(the deterministic batcher, and ``shard_tasks``: the fleet's per-chip
training shards)."""
from repro_torch.data.pipeline import DataState, ShardedBatcher, shard_tasks
from repro_torch.data.ragged import (PadPolicy, bucket_size, eval_masks,
                                     needs_masked_program, pad_tasks)
from repro_torch.data.real import (load_cifar10, load_mnist,
                                   make_keyword_fewshot_tasks,
                                   make_seq_cifar10_tasks,
                                   make_seq_mnist_tasks)
from repro_torch.data.synthetic import (TaskData, lm_token_batch,
                                        make_class_incremental_tasks,
                                        make_drift_tasks,
                                        make_noisy_label_tasks,
                                        make_permuted_tasks,
                                        make_rotated_tasks, make_split_tasks,
                                        make_streaming_tasks)

__all__ = ["TaskData", "lm_token_batch", "make_class_incremental_tasks",
           "make_drift_tasks", "make_noisy_label_tasks",
           "make_permuted_tasks", "make_rotated_tasks", "make_split_tasks",
           "make_streaming_tasks",
           "PadPolicy", "bucket_size", "eval_masks",
           "needs_masked_program", "pad_tasks",
           "load_mnist", "load_cifar10", "make_seq_mnist_tasks",
           "make_seq_cifar10_tasks", "make_keyword_fewshot_tasks",
           "ShardedBatcher", "DataState", "shard_tasks"]
