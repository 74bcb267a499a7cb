"""Image quilting (Efros-Freeman) for terrain texture variation.

The reference synthesizes terrain texture variation with 65-px quilt
blocks and min-error boundary cuts on the CPU (ref: src/render/
gl_image_quilt.c). Candidate-block matching is one batched SSD reduction
over all candidate blocks at once ([C, B, B, 3] tensors), and the
min-error seam is a short dynamic program over the B rows, vectorized
across the overlap width. Blocks are placed in raster order (inherently
sequential), so synthesis runs as a host loop of device steps: a
load-time tool, not a tick-path kernel.

Port of ``permafrost_engine_tpu/ops/quilt.py``: the ``lax.scan`` seams are
plain loops over the rows, on the device of their input; ``image_quilt``
runs on `device` (the card unless the caller names another) and draws its
picks from the same numpy generator, so it returns the JAX package's
texture.
"""

from __future__ import annotations

import numpy as np
import torch


def _candidate_blocks(src: np.ndarray, block: int, stride: int) -> np.ndarray:
    h, w = src.shape[:2]
    out = []
    for r in range(0, h - block + 1, stride):
        for c in range(0, w - block + 1, stride):
            out.append(src[r:r + block, c:c + block])
    return np.stack(out)


def _block_ssd(cands: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """SSD of every candidate against the already-placed pixels.
    cands [C,B,B,3], target [B,B,3], mask [B,B] (1 where placed)."""
    d = (cands - target[None]) ** 2
    return torch.sum(d * mask[None, :, :, None], dim=(1, 2, 3))


def _vertical_seam(err: torch.Tensor) -> torch.Tensor:
    """Min-cost top-to-bottom seam through err [B, O]; returns column index
    per row (the min-error boundary cut)."""
    b, o = err.shape
    inf = torch.full((1,), float("inf"), dtype=err.dtype, device=err.device)
    rows = [err[0]]
    for r in range(1, b):
        prev = rows[-1]                    # [O] best cost to previous row
        left = torch.cat([inf, prev[:-1]])
        right = torch.cat([prev[1:], inf])
        best = torch.minimum(prev, torch.minimum(left, right))
        rows.append(err[r] + best)
    costs = torch.stack(rows)              # [B, O]

    # backtrack: start at the min of the last row, walk up within +-1
    three = torch.arange(3, device=err.device)
    col = torch.argmin(costs[-1])
    cols = [col]
    for r in range(b - 2, -1, -1):
        row_cost = costs[r]
        lo = torch.clamp(col - 1, min=0)
        window = row_cost[torch.clamp(lo + three, max=o - 1)]
        # forbid out-of-range picks at the edges
        window = torch.where(three + lo > torch.clamp(col + 1, max=o - 1),
                             float("inf"), window)
        col = lo + torch.argmin(window)
        cols.append(col)
    return torch.stack(cols[::-1])


def image_quilt(
    src: np.ndarray,
    out_h: int,
    out_w: int,
    *,
    block: int = 64,
    overlap: int = 10,
    stride: int = 8,
    tolerance: float = 1.15,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Synthesize an [out_h, out_w, 3] texture from src (f32 in [0,1])."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    cands_np = _candidate_blocks(src.astype(np.float32), block, stride)
    cands = torch.from_numpy(cands_np).to(dev)
    step = block - overlap
    rows = -(-max(out_h - block, 0) // step) + 1
    cols = -(-max(out_w - block, 0) // step) + 1
    oh = (rows - 1) * step + block
    ow = (cols - 1) * step + block
    out = np.zeros((oh, ow, 3), np.float32)
    placed = np.zeros((oh, ow), np.float32)

    def dev_of(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for br in range(rows):
        for bc in range(cols):
            r0, c0 = br * step, bc * step
            target = dev_of(out[r0:r0 + block, c0:c0 + block])
            mask = dev_of(placed[r0:r0 + block, c0:c0 + block])
            if br == 0 and bc == 0:
                pick = int(rng.integers(len(cands_np)))
            else:
                ssd = _block_ssd(cands, target, mask).cpu().numpy()
                lim = ssd.min() * tolerance + 1e-6
                pool = np.nonzero(ssd <= lim)[0]
                pick = int(rng.choice(pool))
            cand = cands_np[pick]

            blend = np.ones((block, block), np.float32)
            if bc > 0:   # left overlap: vertical seam
                err = torch.sum((dev_of(cand[:, :overlap])
                                 - target[:, :overlap]) ** 2, dim=-1)
                seam = _vertical_seam(err).cpu().numpy()
                cols_idx = np.arange(overlap)[None, :]
                blend[:, :overlap] = (cols_idx >= seam[:, None]).astype(np.float32)
            if br > 0:   # top overlap: horizontal seam (transpose trick)
                err = torch.sum((dev_of(cand[:overlap, :])
                                 - target[:overlap, :]) ** 2, dim=-1).T
                seam = _vertical_seam(err).cpu().numpy()   # [B] per col
                rows_idx = np.arange(overlap)[:, None]
                blend[:overlap, :] *= (rows_idx >= seam[None, :]).astype(np.float32)

            region = out[r0:r0 + block, c0:c0 + block]
            m3 = blend[..., None]
            out[r0:r0 + block, c0:c0 + block] = cand * m3 + region * (1 - m3)
            placed[r0:r0 + block, c0:c0 + block] = 1.0

    return out[:out_h, :out_w]
