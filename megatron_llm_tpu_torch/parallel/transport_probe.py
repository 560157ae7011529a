"""Time the transport of two ranks that share one GPU over gloo (NCCL
refuses two ranks on one device): the pieces of a host-staged collective
of a CUDA tensor against ``parallel/mappings.py``'s shared-device
mailbox, at the sizes of ``chip_smoke.py`` phases 54-55::

    python3 -m megatron_llm_tpu_torch.parallel.transport_probe

For each size and dtype, the mean milliseconds over a few calls of: the
copy to pinned host memory and back, gloo's all-reduce, all-gather and
reduce-scatter of the host buffer, and ``mappings.all_gather`` /
``reduce_scatter`` / ``all_reduce`` end to end (the mailbox on a card).
Rank 0 prints one JSON line a case; the ranks run on ``cuda:0``
(``--device cpu`` on a host without a card; ``--small`` divides every
size by 64).
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

# (label, elements, dtype): one SP gather of Llama-2-7B widths at seq 4096
# (b 1, s 2048 a rank, h 4096, bf16), one stacked fp32 grad leaf of 4
# layers ([4, 4096, 11008]), the bf16 params of the same leaf
CASES = (("sp activation bf16 2048x4096", 2048 * 4096, torch.bfloat16),
         ("grad leaf fp32 4x4096x11008", 4 * 4096 * 11008, torch.float32),
         ("param leaf bf16 4x4096x11008", 4 * 4096 * 11008, torch.bfloat16))
ITERS = 3


def _ms(fn, sync) -> float:
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(ITERS):
        fn()
    sync()
    return (time.perf_counter() - t) / ITERS * 1e3


def _rank(rank: int, world: int, rdv: str, device: str, shrink: int) -> None:
    from . import mappings

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=5))
    group = dist.new_group(list(range(world)))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    for label, n, dtype in CASES:
        n //= shrink
        x = torch.randn(n, device=dev).to(dtype)
        host = torch.empty(n, dtype=dtype, pin_memory=dev.type == "cuda")
        out = torch.empty(n * world, dtype=dtype)
        part = torch.empty(n // world, dtype=dtype)
        row = {"case": label, "mbytes": n * x.element_size() / 2 ** 20}
        row["d2h_ms"] = _ms(lambda: host.copy_(x), sync)
        row["h2d_ms"] = _ms(lambda: x.copy_(host), sync)
        row["gloo_all_reduce_ms"] = _ms(
            lambda: dist.all_reduce(host, group=group), sync)
        row["gloo_all_gather_ms"] = _ms(
            lambda: mappings._all_gather(out, host, group=group), sync)
        row["gloo_reduce_scatter_ms"] = _ms(
            lambda: mappings._reduce_scatter(part, host, group=group), sync)
        row["mappings_all_reduce_ms"] = _ms(
            lambda: mappings.all_reduce(x, group), sync)
        row["mappings_all_gather_ms"] = _ms(
            lambda: mappings.all_gather(x, group, 0), sync)
        row["mappings_reduce_scatter_ms"] = _ms(
            lambda: mappings.reduce_scatter(x, group, 0), sync)
        if rank == 0:
            print(json.dumps(row), flush=True)
        del x, host, out, part
    mappings.release_mailboxes()
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--device" in argv and "cpu" in argv else "cuda"
    shrink = 64 if "--small" in argv else 1
    with tempfile.TemporaryDirectory() as work:
        mp.start_processes(_rank, args=(2, os.path.join(work, "rdv"), device,
                                        shrink),
                           nprocs=2, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
