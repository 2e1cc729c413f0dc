"""Exact greedy NMS on the card: CUDA kernel N1 and its plain version.

The keep step of ops/nms.nms on CUDA tensors: rank-sorted boxes (B, N, 4)
fp32 and their validity (B, N) bool in rank order -> the greedy keep mask
(B, N) bool in rank order (row i kept iff valid and no kept row ranked
above it has IoU > threshold with it). It runs in the hand-written Hopper
kernel `csrc/nms.cu`, which reads each image's valid extent on the device
and never returns it to the host, so the pyramid around it can be captured
into a CUDA graph. It has no Pallas ancestor: it stands where the JAX
package's NMS runs its device loops (tinyfaces_tpu/ops/nms.py:42, :119).

`nms_bitmask_reference` is the plain PyTorch version of the same algorithm:
the valid extent taken from a tensor, the (B, N, W) suppression words (W =
ceil(N / 64)), then the scan over 64-row chunks, each chunk resolved row by
row against its diagonal word and its kept rows' words ORed into the later
chunks. Its loops run over the shapes only, never over data read back, so
it makes no host read either. The CPU tests hold it against the JAX NMS and
against ops/nms._fixpoint_keep; chip_smoke.py holds the kernel against both
on the card.

ops/nms.nms is the one dispatch point: CPU tensors take its plain
fixpoint, any other tensors go to `_launch`, which takes CUDA tensors only
and raises when the kernel fails to build or launch; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from tinyfaces_tpu_torch.ops.boxes import pairwise_iou

WORD = 64  # rows and columns of a mask tile, bits of a suppression word
MAX_N = 65536  # the scan's shared suppressed set (csrc/nms.cu kMaxN)
MAX_B = 65535  # the mask launch's grid.z

# H100 SXM published peaks (NVIDIA's data sheet, dense) and the scan's
# step: one dependent test-and-OR in registers, taken as 8 cycles at the
# 1.98 GHz boost clock. The 67 TFLOP/s fp32 peak counts an FMA as two
# operations; N1's IoU has no FMA (built with --fmad=false), so each of its
# operations takes one issue slot: 132 SMs x 128 fp32 lanes x 1.98 GHz.
FP32_ISSUE_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# 2 max, 2 min, 2 sub, 2 clamp, mul, add, sub, compare, div, compare; the
# division counted as one (its IEEE sequence takes more), so the bound stays
# a floor
OPS_PER_PAIR = 14
CHAIN_STEP_S = 8 / 1.98e9

# Number of kernel launches in this process (one per wrapper call); a run
# reads it to show that the main path went through the kernel. A launch made
# while a CUDA graph is being captured only records the kernel: it counts in
# `captured_count`, and each replay of that graph counts its launches
# (`count_replay`).
launch_count = 0
captured_count = 0

_fn = None


def words(n: int) -> int:
    """Suppression words of a row of n candidates."""
    return (n + WORD - 1) // WORD


def valid_extent(valid: torch.Tensor) -> torch.Tensor:
    """(B,) int64 on valid's device: one past the last valid rank of each
    image (its valid count when the valid rows rank first), 0 without one."""
    b, n = valid.shape
    pos = torch.arange(1, n + 1, device=valid.device).expand(b, n)
    return torch.where(valid, pos, 0).amax(1) if n else torch.zeros(b, dtype=torch.int64,
                                                                    device=valid.device)


def suppression_words(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain mask step: ((B, N, W) int64 words, (B,) extent). Bit j of
    word w of row i is set where column c = 64 w + j is ranked below i, both
    lie inside the image's extent and IoU(i, c) > threshold."""
    b, n = valid.shape
    w = words(n)
    extent = valid_extent(valid)
    pos = torch.arange(n, device=boxes.device)
    inside = pos[None, :] < extent[:, None]
    over = (pairwise_iou(boxes, boxes) > iou_threshold) & (pos[None, :, None] < pos[None, None, :])
    over = over & inside[:, :, None] & inside[:, None, :]
    over = torch.nn.functional.pad(over, (0, w * WORD - n)).view(b, n, w, WORD)
    shifts = torch.arange(WORD, device=boxes.device, dtype=torch.int64)
    # distinct bits: the sum is their OR (bit 63 wraps to the sign bit)
    return (over.to(torch.int64) << shifts).sum(-1), extent


def nms_bitmask_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """(B, N, 4) rank-sorted boxes, (B, N) validity -> (B, N) greedy keep,
    by N1's algorithm in plain PyTorch (see the module docstring)."""
    b, n = valid.shape
    w = words(n)
    mask, extent = suppression_words(boxes, valid, iou_threshold)
    dev = valid.device
    pos = torch.arange(w * WORD, device=dev)
    live = torch.nn.functional.pad(valid, (0, w * WORD - n)) & (pos[None, :] < extent[:, None])
    mask = torch.nn.functional.pad(mask, (0, 0, 0, w * WORD - n))  # rows past N: no bits
    sup = torch.zeros(b, w, dtype=torch.int64, device=dev)
    keep = torch.zeros(b, w * WORD, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(w):
        rows = slice(c * WORD, (c + 1) * WORD)
        s = sup[:, c]
        for j in range(WORD):
            i = c * WORD + j
            k = live[:, i] & (((s >> j) & 1) == 0)
            keep[:, i] = k
            s = s | torch.where(k, mask[:, i, c], zero)  # bits above j only
        kept_words = torch.where(keep[:, rows, None], mask[:, rows, :], zero)  # (B, 64, W)
        later = (torch.arange(w, device=dev) > c)[None, :]
        sup = sup | torch.where(later, functools.reduce(torch.bitwise_or, kept_words.unbind(1)), zero)
    return keep[:, :n]


def nms_bound(valid: Sequence[int] | torch.Tensor, n: int, keep: torch.Tensor | None = None) -> dict:
    """The least time N1's work could take on an H100 SXM, for images whose
    valid extents are `valid` (B,) among n candidates each, in ms:

    * operations: the IoU tests greedy NMS needs, 14 fp32 operations each
      at one issue slot (FP32_ISSUE_PER_S). With `keep` (the (B, N) keep
      mask in rank order) they are the pairs whose higher-ranked box is
      kept: sum over kept i < n_b of n_b - 1 - i; without it, every valid
      pair, n_b (n_b - 1) / 2 per image;
    * bytes: the function's inputs read once (boxes 16 B, validity 1 B a
      row) and its output written once (1 B a row), against 3.35 TB/s.

    `bound_ms` is the larger of the two and `bound_by` names it. Two floors
    of N1's own design are given beside it: `mask_bytes_ms`, the
    suppression words of the upper-triangle tiles written once and read
    once, and `serial_chain_ms`, the scan's n_b dependent steps of the
    longest image (8 cycles a step at 1.98 GHz)."""
    ext = [int(e) for e in (valid.tolist() if isinstance(valid, torch.Tensor) else valid)]
    b = len(ext)
    pairs = sum(e * (e - 1) // 2 for e in ext)
    needed = pairs
    if keep is not None:
        rows = torch.arange(keep.shape[1], device=keep.device)
        ext_t = torch.tensor(ext, device=keep.device)
        later = (ext_t[:, None] - 1 - rows[None, :]).clamp(min=0)
        needed = int(torch.where(keep & (rows[None, :] < ext_t[:, None]), later, 0).sum())
    ops_ms = OPS_PER_PAIR * needed / FP32_ISSUE_PER_S * 1e3
    bytes_ms = b * n * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3
    # rows of tile r carry the words of tiles r..t-1, t = ceil(n_b / 64)
    mask_words = sum(min(WORD, e - r * WORD) * (math.ceil(e / WORD) - r)
                     for e in ext for r in range(math.ceil(e / WORD)))
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms, "valid_pairs": pairs,
            "needed_pairs": needed,
            "mask_bytes_ms": 2 * 8 * mask_words / HBM_BYTES_PER_S * 1e3,
            "serial_chain_ms": max(ext, default=0) * CHAIN_STEP_S * 1e3}


def _kernel():
    global _fn
    if _fn is None:
        from tinyfaces_tpu_torch.utils.cuda_build import load_library

        fn = load_library("nms").tf_nms_keep
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 2  # boxes, valid
            + [ctypes.c_int] * 2  # B, N
            + [ctypes.c_float]  # threshold
            + [ctypes.c_void_p] * 4  # mask, extent, keep, stream
        )
        _fn = fn
    return _fn


def workspace(b: int, n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """N1's scratch: the (B, N, W) uint64 suppression words (~64.5 MB at
    B = 32, N = 4000), as int64, and the (B,) int32 extents."""
    return (torch.empty(b, n, words(n), dtype=torch.int64, device=device),
            torch.empty(b, dtype=torch.int32, device=device))


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    global launch_count, captured_count
    if not boxes.is_cuda:
        raise ValueError(f"N1 runs on CUDA tensors; boxes are on {boxes.device}")
    if valid.device != boxes.device:
        raise ValueError(f"valid on {valid.device}, boxes on {boxes.device}")
    b, n = valid.shape
    if boxes.shape != (b, n, 4) or boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"N1 takes (B, N, 4) float32 boxes and (B, N) bool validity; got "
                         f"{tuple(boxes.shape)} {boxes.dtype} and {tuple(valid.shape)} {valid.dtype}")
    if n > MAX_N or b > MAX_B:
        raise ValueError(f"N1 takes N <= {MAX_N} and B <= {MAX_B}; got N={n}, B={b}")
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    boxes, valid = boxes.contiguous(), valid.contiguous()
    mask, extent = workspace(b, n, boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _kernel()(boxes.data_ptr(), valid.data_ptr(), b, n, float(iou_threshold),
                        mask.data_ptr(), extent.data_ptr(), keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    if torch.cuda.is_current_stream_capturing():
        captured_count += 1
    else:
        launch_count += 1
    return keep


def count_replay(launches: int) -> None:
    """A replay of a CUDA graph that holds `launches` recorded launches of
    the kernel has run them."""
    global launch_count
    launch_count += launches
