"""Data parallelism over torch.distributed (counterpart of
cartseg_tpu/parallel): DDP training with the BatchNorm statistics summed
over the ranks, per-rank batch rows, and the row-split inference program
over this process's devices."""

from cartseg_tpu_torch.parallel.mesh import (
    all_reduce_mean, all_reduce_min, all_reduce_sum, backend_for, barrier,
    host_batch_slice, init_distributed, is_main_process,
    local_device, local_device_count, maybe_initialize_distributed,
    process_count, process_index, shard_inference_program, training_group,
)

__all__ = [
    "local_device_count", "process_count", "process_index",
    "maybe_initialize_distributed", "is_main_process", "barrier",
    "host_batch_slice", "shard_inference_program", "init_distributed",
    "backend_for", "local_device", "training_group", "all_reduce_sum",
    "all_reduce_min", "all_reduce_mean",
]
