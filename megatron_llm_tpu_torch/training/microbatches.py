"""Global-batch-size schedule → number of microbatches (a copy of
``megatron_llm_tpu/training/microbatches.py``; reference
megatron/microbatches.py:9-145): a constant calculator and a linear ramp
that grows the global batch from ``start`` by ``increment`` every
``ramp_samples / ((gbs - start) / increment)`` consumed samples.
Divisibility is checked at every rung.
"""

from __future__ import annotations

from typing import Optional, Sequence


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches = 0
        self.current_global_batch_size = 0

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        pass


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        micro_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_times_dp:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("global batch size below one micro batch")
        self.current_global_batch_size = global_batch_size


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel = (
            micro_batch_size * data_parallel_size)
        diff = global_batch_size - start_batch_size
        if (global_batch_size <= 0 or batch_size_increment <= 0
                or ramup_samples < 0 or diff < 0
                or start_batch_size % self.micro_batch_times_data_parallel):
            raise ValueError(
                f"bad batch-size ramp: start {start_batch_size}, increment "
                f"{batch_size_increment}, samples {ramup_samples}, global "
                f"{global_batch_size}, micro x dp "
                f"{self.micro_batch_times_data_parallel}")
        if diff % batch_size_increment:
            raise ValueError("expected global batch size interval to be "
                             "divisible by the batch size increment")
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            ramup_samples / num_increments if num_increments > 0 else 0)
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        # a degenerate ramp (start == target, or zero ramp samples) jumps
        # straight to the full global batch
        if (consumed_samples > self.ramup_samples
                or self.rampup_samples_per_increment == 0):
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
        if consistency_check and (self.current_global_batch_size
                                  % self.micro_batch_times_data_parallel):
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                f"micro-batch-size ({self.micro_batch_size}) times data "
                f"parallel size ({self.data_parallel_size})")
        self.num_micro_batches = (self.current_global_batch_size
                                  // self.micro_batch_times_data_parallel)


def build_num_microbatches_calculator(
        global_batch_size: int, micro_batch_size: int,
        data_parallel_size: int,
        rampup_batch_size: Optional[Sequence[int]] = None,
) -> NumMicroBatchesCalculator:
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(global_batch_size, micro_batch_size,
                                       data_parallel_size)
    if len(rampup_batch_size) != 3:
        raise ValueError("expected the following format: --rampup_batch_size "
                         "<start batch size> <batch size increment> "
                         "<ramp-up samples>")
    start, increment, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, increment, samples, global_batch_size, micro_batch_size,
        data_parallel_size)
