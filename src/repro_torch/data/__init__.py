"""Task streams — counterpart of ``repro/data`` (the synthetic
generators; ``pipeline``, ``ragged`` and ``real`` are not ported yet)."""
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
           "make_streaming_tasks"]
