"""Data parallelism across processes, one per card (mrfp_tpu/parallel)."""

from mrfp_tpu_torch.parallel.dist import (all_gather_rows, all_reduce_grads, all_reduce_sum,
                                          all_reduce_sum_grad, barrier, broadcast,
                                          initialize_distributed, is_coordinator,
                                          local_device, rank, world)

__all__ = ["all_gather_rows", "all_reduce_grads", "all_reduce_sum", "all_reduce_sum_grad",
           "barrier", "broadcast", "initialize_distributed", "is_coordinator", "local_device",
           "rank", "world"]
