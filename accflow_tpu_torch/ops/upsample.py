"""RAFT convex-combination 8x flow upsampling, counterpart of
accflow_tpu/ops/upsample.py:

    out[n, 8i+r, 8j+s, c] = sum_k softmax_k(mask)[n, i, j, k, r, s]
                            * 8 * flow_pad[n, i + ky(k) - 1, j + kx(k) - 1, c]

with k = ky*3 + kx over the zero-padded 3x3 neighbourhood and the mask
channel layout c = k*64 + r*8 + s (the canonical, checkpoint layout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accflow_tpu_torch.parallel import mesh


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, spatial=None) -> torch.Tensor:
    """flow (N, H, W, 2), mask (N, H, W, 576) -> (N, 8H, 8W, 2) float32.

    The convex combination is an elementwise product and a sum over the 9
    taps (no matmul, so no TF32 rounding on the card). spatial (a
    parallel.mesh.Spatial handle): flow and mask are this rank's rows, and
    the 3x3 neighbourhood reads one halo row of the flow above and below
    (mesh.halo_rows; zeros past the image's edges, as the padding)."""
    n, h, w, _ = flow.shape
    m = mask.permute(0, 3, 1, 2).float().reshape(n, 1, 9, 8, 8, h, w)
    m = torch.softmax(m, dim=2)
    f = 8.0 * flow.float().permute(0, 3, 1, 2)
    if spatial is None:
        nbh = F.unfold(f, (3, 3), padding=1)
    else:
        above, below = mesh.halo_rows(f, spatial, 1, 1)
        nbh = F.unfold(torch.cat([above, f, below], dim=2), (3, 3), padding=(0, 1))
    nbh = nbh.view(n, 2, 9, 1, 1, h, w)
    up = (m * nbh).sum(dim=2)  # (N, 2, r, s, H, W)
    return up.permute(0, 4, 2, 5, 3, 1).reshape(n, 8 * h, 8 * w, 2)
