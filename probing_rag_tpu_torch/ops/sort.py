"""Row-wise (int32 key, f32 value) sort: the CUDA bitonic network and its
plain PyTorch version.

Port of ``probing_rag_tpu/ops/pallas_sort.py`` (``sort_pairs_pallas`` and
``sort_pairs_pallas_wide``): one CUDA network
(``kernels/csrc/bitonic_sort.cu``) covers every power-of-two width from 2
to 2M. Keys come out ascending and every (key, value) pair is preserved;
the order of values within one key is free.
"""

from __future__ import annotations

from typing import Tuple

import torch

from probing_rag_tpu_torch import kernels

MAX_SORT_WIDTH = 1 << 21
# rows wider than this are the TPU's "wide" sort (_bitonic_wide_kernel);
# the launch counts keep the two apart
NARROW_SORT_MAX = 1 << 15


def sort_pairs_plain(
    keys: torch.Tensor, vals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: stable ``torch.sort`` of the keys, values gathered."""
    out_k, idx = torch.sort(keys, dim=1, stable=True)
    return out_k, torch.gather(vals, 1, idx)


def _check(keys: torch.Tensor, vals: torch.Tensor, k_start: int) -> None:
    if keys.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"need int32 keys and f32 values, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 2 or keys.shape != vals.shape:
        raise ValueError(f"need matching [Q, P] rows, got {tuple(keys.shape)}, {tuple(vals.shape)}")
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, values on {vals.device}")
    p = keys.shape[1]
    if p < 2 or p & (p - 1) or p > MAX_SORT_WIDTH:
        raise ValueError(f"row width must be a power of two in [2, {MAX_SORT_WIDTH}], got {p}")
    if k_start < 2 or k_start & (k_start - 1):
        raise ValueError(f"k_start must be a power of two >= 2, got {k_start}")


def sort_pairs(
    keys: torch.Tensor,  # [Q, P] int32, P a power of two
    vals: torch.Tensor,  # [Q, P] f32
    *,
    k_start: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise ascending sort of (key, value) pairs.

    ``k_start`` skips the network's passes below it: the caller guarantees
    that every aligned ``k_start // 2``-wide block of each row is already
    sorted, ascending at even block index and descending at odd (the BM25
    gather produces exactly this with ``k_start = 2 * block``).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(keys, vals, k_start)
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, vals)
    if keys.device.type != "cuda":
        raise ValueError(f"no sort for device {keys.device}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("sort_pairs needs contiguous rows")
    q, p = keys.shape
    if k_start > p or q == 0:
        return keys.clone(), vals.clone()
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    lib = kernels.library()
    with torch.cuda.device(keys.device):
        kernels.check(
            lib.bitonic_sort_pairs(
                keys.data_ptr(), vals.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
                q, p, k_start, kernels.stream_ptr(keys.device),
            ),
            "bitonic_sort_pairs",
        )
    kernels.LAUNCHES["bitonic_sort" if p <= NARROW_SORT_MAX else "bitonic_sort_wide"] += 1
    return out_k, out_v
