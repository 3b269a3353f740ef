"""Host-to-device input pipeline: depth-k prefetch of training batches (the
counterpart of the JAX package's ``train/data_pipeline.py``).

Batch i is sliced from the numpy arrays and its copy to the device is
issued ``depth`` batches before the step that consumes it.  On a CUDA
device the slices are staged in pinned host memory and copied with
``non_blocking=True``, so the copies overlap the running steps.  No
threads, the same order as slicing inline, nothing to shut down.  Under a
dp mesh each rank slices and copies only its rows of every global batch
(``parallel.shard_rows``), in the same batch order.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch

from ..parallel.mesh import shard_rows


def prefetch_batches(train_x, train_y, train_mask, batch_size: int, device="cuda",
                     depth: int = 2, mesh=None) -> Iterator[Tuple[int, tuple]]:
    """Yield (batch_index, (x, y, mask)) on ``device``: x, y int64, mask
    float32.  Partial last batches are dropped, as in the JAX package.
    ``mesh``: this rank's rows of each global batch of ``batch_size``."""
    device = torch.device(device)
    num_batch = len(train_x) // batch_size
    depth = max(1, depth)
    pin = device.type == "cuda"

    def dispatch(i: int):
        lo, hi = i * batch_size, (i + 1) * batch_size
        if mesh is not None:
            rows = shard_rows(mesh, batch_size)
            lo, hi = lo + rows.start, lo + rows.stop
        out = []
        for arr, dt in ((train_x, np.int64), (train_y, np.int64), (train_mask, np.float32)):
            t = torch.from_numpy(np.ascontiguousarray(arr[lo:hi], dtype=dt))
            if pin:
                t = t.pin_memory()
            out.append(t.to(device, non_blocking=True))
        return tuple(out)

    window: deque = deque()
    for i in range(min(depth, num_batch)):
        window.append(dispatch(i))
    for i in range(num_batch):
        batch = window.popleft()
        if i + depth < num_batch:
            window.append(dispatch(i + depth))
        yield i, batch
