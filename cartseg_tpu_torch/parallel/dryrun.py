"""A data-parallel dry run (counterpart of
`__graft_entry__.dryrun_multichip`): n ranks, one full train step each
on its rows of a seeded global batch: the augmentation from global
draws, the forward and backward of an efficientnet-b0 UNet at 32^2 with
its BatchNorm statistics summed over the ranks, DDP's gradient average
and the per-group AdamW update. Rank 0 prints the loss and `ok`.

    python -m cartseg_tpu_torch.parallel.dryrun --n 2 --device cpu
    python -m cartseg_tpu_torch.parallel.dryrun --n 2            # the card

The ranks meet at a file:// rendezvous in a temporary directory; gloo on
the CPU or when the ranks share one card, NCCL when each has its own
(parallel/mesh.py `backend_for`).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

HW = 32


def _rank(rank: int, n: int, init: str, device: str) -> None:
    import torch.distributed as dist

    from cartseg_tpu_torch.parallel import mesh
    from cartseg_tpu_torch.train import LossSpec, TrainConfig, Trainer
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame

    if device == "cpu":
        torch.set_num_threads(1)
    mesh.init_distributed(rank, n, init, device)
    try:
        cfg = TrainConfig(encoder="efficientnet-b0", img_size=(HW, HW),
                          batch_size=2 * n, compute_dtype="bfloat16",
                          augment="train_512", loss=LossSpec("bce_dice"),
                          device=device, seed=0)
        tr = Trainer(cfg)
        st = tr.init_state()
        r = np.random.default_rng(0)
        B = cfg.batch_size
        imgs = torch.from_numpy(np.stack([frame(r, (HW, HW))
                                          for _ in range(B)]))
        masks = torch.from_numpy(blob_masks(r, (B, HW, HW), n=2)[..., None]
                                 .astype(np.float32))
        rows = mesh.host_batch_slice(B)
        before = next(st.model.parameters()).detach().clone()
        loss, ok, _ = tr.train_step(
            st, imgs[rows].to(tr.device), masks[rows].to(tr.device),
            torch.ones(rows.stop - rows.start, device=tr.device),
            [1e-4] * 3, [1.0] * 3, tr.group_ids(st))
        loss = float(loss)
        if not np.isfinite(loss) or float(ok) != 1.0:
            raise RuntimeError(f"rank {rank}: non-finite loss {loss}")
        if torch.equal(before, next(st.model.parameters()).detach()):
            raise RuntimeError(f"rank {rank}: the update changed nothing")
        if rank == 0:
            print(f"dryrun({n} ranks, {dist.get_backend()}, {device}): "
                  f"loss={loss:.4f}")
            print("ok", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun(n: int = 2, device: str = "cuda") -> None:
    """Spawn n ranks for one train step each; raises if a rank fails."""
    if torch.device(device).type == "cuda":
        from cartseg_tpu_torch.device import require_cuda

        require_cuda()
    with tempfile.TemporaryDirectory() as td:
        init = f"file://{Path(td) / 'rendezvous'}"
        mp.start_processes(_rank, args=(n, init, device), nprocs=n,
                           join=True, start_method="spawn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dryrun(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
