"""Host packing of matrices into the shared-memory layout of Hopper's
``wgmma`` operands (``csrc/hopper.cuh``).

A ``wgmma`` operand read from shared memory is K-major: for each of its R
rows (M or N of the product) K contiguous elements. Without swizzle, its
canonical layout is a grid of core matrices of 8 rows by 16 bytes of K,
stored as ``[K·es/16][R][16/es]`` (``es`` the element size). A kernel that
finds a weight matrix already in that layout in device memory moves it into
shared memory with one bulk copy. ``kmajor_tiles`` packs, zero-padding R and
K to the kernel's tile.
"""

from __future__ import annotations

import torch


def kmajor_tiles(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``w`` [..., R, C] (R the operand's rows, C its K) zero-padded to
    [..., rows, cols] and laid out as [..., cols·es/16, rows, 16/es]:
    contiguous, in ``w``'s dtype and on its device. ``cols·es`` must be a
    multiple of 16."""
    *lead, r, c = w.shape
    per = 16 // w.element_size()
    if rows < r or cols < c or cols % per:
        raise ValueError(f"[{r}, {c}] does not pad to [{rows}, {cols}] in whole "
                         f"16-byte groups of {per}")
    if (rows, cols) != (r, c):
        padded = w.new_zeros(*lead, rows, cols)
        padded[..., :r, :c] = w
        w = padded
    return w.reshape(*lead, rows, cols // per, per).transpose(-3, -2).contiguous()

