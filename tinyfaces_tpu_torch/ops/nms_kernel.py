"""Exact greedy NMS on the card: CUDA kernel N1 and its plain version.

The keep step of ops/nms.nms on CUDA tensors: rank-sorted boxes (B, N, 4)
fp32 and their validity (B, N) bool in rank order -> the greedy keep mask
(B, N) bool in rank order (row i kept iff valid and no kept row ranked
above it has IoU > threshold with it). It runs in the hand-written Hopper
kernel `csrc/nms.cu`: one launch, a thread-block cluster of up to 8 blocks
per image (launch_shape), the image's boxes, a bitset of its dead rows and
lists of its live rows in shared memory, no workspace in device memory and
no host read, so the pyramid around it can be captured into a CUDA graph.
It has no Pallas ancestor: it stands where the JAX package's NMS runs its
device loops (tinyfaces_tpu/ops/nms.py:42, :119), and runs that module's
blocked scheme at 64 rows a block.

`nms_blocked_reference` is the plain PyTorch version of the same
algorithm: the 64-row chunks in rank order, each (`chunk_step`) resolved
row by row against its diagonal tile of overlaps between live rows (the
kernel takes the same chunk's kept set as a Jacobi fixpoint, which is the
same set), then its kept rows' forward suppression of every row ranked
below it. Its loops run over the shapes only, never over data read back,
so it makes no host read either and runs on `meta` tensors. The CPU tests
hold it against the JAX NMS and against ops/nms._fixpoint_keep;
chip_smoke.py holds the kernel against both on the card.

ops/nms.nms is the one dispatch point: CPU tensors take its plain
fixpoint, any other tensors go to `_launch`, which takes CUDA tensors only
and raises when the kernel fails to build or launch; there is no fallback.
Each launch counts as "n1" in utils/graphs.launches.
"""

from __future__ import annotations

import ctypes
import torch

from tinyfaces_tpu_torch.ops.boxes import pairwise_iou
from tinyfaces_tpu_torch.utils import graphs

CHUNK = 64  # rows resolved together (csrc/nms.cu kChunk)
MAX_N = 65536  # candidates an image (csrc/nms.cu kMaxN): 16-bit row numbers
# Shared memory a block may opt in to on an H100 (232,448 bytes): the rows
# of an image past smem_rows(n) are read from device memory.
H100_SMEM_OPTIN = 232448

# H100 SXM published peaks (NVIDIA's data sheet, dense). The 67 TFLOP/s
# fp32 peak counts an FMA as two operations; N1's IoU has no FMA (built
# with --fmad=false), so each of its operations takes one issue slot: 132
# SMs x 128 fp32 lanes x 1.98 GHz.
FP32_ISSUE_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# 2 max, 2 min, 2 sub, 2 clamp, mul, add, sub, compare, div, compare; the
# division counted as one (its IEEE sequence takes more), so the bound stays
# a floor
OPS_PER_PAIR = 14
# The resolve chain of one image, at the 1.98 GHz boost clock: a chunk takes
# at least two Jacobi rounds (one that settles it, one that finds it
# settled), each an OR-reduction over a warp taken as 30 cycles, and two
# block barriers, each taken as 20 cycles.
CLOCK_HZ = 1.98e9
ROUND_CYCLES = 30
BARRIER_CYCLES = 20

_fn = None


def chunks(n: int) -> int:
    """64-row chunks of n candidates."""
    return (n + CHUNK - 1) // CHUNK


def smem_rows(n: int, optin: int = H100_SMEM_OPTIN, threads: int = 1024) -> int:
    """Rows of an image of n candidates that N1 stages in shared memory on a
    card that lets a block have `optin` bytes, counted by hand as
    csrc/nms.cu's smem_rows counts them (chip_smoke.py holds the two
    against each other through launch_geometry): what
    is left after two buffers of kept boxes and areas (2 x 64 x 20 B), the
    diagonal (512 B), four ints, the dead bitset (8 B a chunk) and the
    warps' lists of live rows (room for every (warps - 1)-th bitset word,
    2 B a row), at 16 B a row; 12,034 at N = 16,000 on an H100."""
    warps, words = threads // 32, 2 * chunks(n)
    room = 32 * ((words + warps - 2) // (warps - 1))
    fixed = 2 * CHUNK * 20 + CHUNK * 8 + 4 * 4 + 8 * chunks(n) + 2 * warps * room
    return max(0, min(n, (optin - fixed) // 16))


def launch_shape(b: int) -> tuple[int, int]:
    """(blocks a cluster, threads a block) N1 takes for b images, a hand
    copy of csrc/nms.cu's launch_shape (held against it on the card through
    launch_geometry): the first of 8 x 1024, 4 x 1024, 4 x 512
    and 2 x 512 with at most 65,536 threads in all, else 1 x 1024; on an
    H100 more clusters no longer run in one wave."""
    for cs, threads in ((8, 1024), (4, 1024), (4, 512), (2, 512)):
        if b * cs * threads <= 65536:
            return cs, threads
    return 1, 1024


def valid_extent(valid: torch.Tensor) -> torch.Tensor:
    """(B,) int64 on valid's device: one past the last valid rank of each
    image (its valid count when the valid rows rank first), 0 without one."""
    b, n = valid.shape
    pos = torch.arange(1, n + 1, device=valid.device).expand(b, n)
    return torch.where(valid, pos, 0).amax(1) if n else torch.zeros(b, dtype=torch.int64,
                                                                    device=valid.device)


def chunk_step(boxes: torch.Tensor, dead: torch.Tensor, c: int, iou_threshold: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk c of N1's loop in plain PyTorch, on (B, M, 4) rank-sorted boxes
    padded to whole chunks and the (B, M) dead mask (rows invalid,
    suppressed, or resolved and not kept). Returns the chunk's diagonal
    tile (B, 64, 64), [r, j] set where live rows r < j of the chunk have
    IoU > threshold; its kept rows (B, 64), resolved in rank order from the
    carried-in dead mask (a live row is kept and its row of the tile
    suppresses the rows below it); and the dead mask after the chunk: its
    own rows dead unless kept, every later row dead if it was or if a kept
    row of the chunk has IoU > threshold with it."""
    rows = slice(c * CHUNK, (c + 1) * CHUNK)
    own = boxes[:, rows]
    live = ~dead[:, rows]
    upper = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=boxes.device).triu(1)
    diag = (pairwise_iou(own, own) > iou_threshold) & upper & live[:, :, None] & live[:, None, :]
    cand = live
    kept = torch.zeros_like(live)
    for j in range(CHUNK):
        kept[:, j] = cand[:, j]
        cand = cand & ~(diag[:, j] & cand[:, j, None])
    later = boxes[:, (c + 1) * CHUNK:]
    sup = ((pairwise_iou(own, later) > iou_threshold) & kept[:, :, None]).any(1)
    dead = torch.cat([dead[:, :c * CHUNK], ~kept, dead[:, (c + 1) * CHUNK:] | sup], 1)
    return diag, kept, dead


def nms_blocked_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """(B, N, 4) rank-sorted boxes, (B, N) validity -> (B, N) greedy keep,
    by N1's algorithm in plain PyTorch (see the module docstring): the rows
    padded to whole chunks, dead where invalid, then chunk_step over every
    chunk. The kernel stops at the chunk of the valid extent; the chunks
    past it hold no live row and change nothing here."""
    b, n = valid.shape
    pad = chunks(n) * CHUNK - n
    boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
    dead = ~torch.nn.functional.pad(valid, (0, pad))
    for c in range(chunks(n)):
        dead = chunk_step(boxes, dead, c, iou_threshold)[2]
    return ~dead[:, :n]


def nms_bound(valid: torch.Tensor, keep: torch.Tensor) -> dict:
    """The least time greedy NMS of these inputs could take on an H100 SXM,
    for the (B, N) validity and the (B, N) keep mask in rank order, in ms:

    * operations: the IoU tests any exact algorithm must make on this
      data, 14 fp32 operations each at one issue slot (FP32_ISSUE_PER_S,
      33.5 T op/s). Each pair of kept rows must be shown not to overlap,
      K (K - 1) / 2 an image of K kept rows, and each valid row not kept
      must meet the one kept row that suppresses it, one test apiece;
      invalid rows need none;
    * bytes: the function's inputs read once (boxes 16 B, validity 1 B a
      row) and its output written once (1 B a row), against 3.35 TB/s.

    `bound_ms` is the larger of the two and `bound_by` names it. Beside it,
    the floor of N1's own design, `serial_chain_ms`: the chunks of the
    longest valid extent one after another, each at least two resolve
    rounds and two block barriers (ROUND_CYCLES, BARRIER_CYCLES) at 1.98
    GHz."""
    b, n = valid.shape
    nv = valid.sum(1).tolist()
    nk = (keep & valid).sum(1).tolist()
    needed = sum(k * (k - 1) // 2 + v - k for v, k in zip(nv, nk))
    ops_ms = OPS_PER_PAIR * needed / FP32_ISSUE_PER_S * 1e3
    bytes_ms = b * n * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3
    chain = 2 * (ROUND_CYCLES + BARRIER_CYCLES) * chunks(int(valid_extent(valid).max()) if b else 0)
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms, "kept": sum(nk),
            "valid_pairs": sum(v * (v - 1) // 2 for v in nv), "needed_pairs": needed,
            "serial_chain_ms": chain / CLOCK_HZ * 1e3}


def _kernel():
    global _fn
    if _fn is None:
        from tinyfaces_tpu_torch.utils.cuda_build import load_library

        lib = load_library("nms")
        fn = lib.tf_nms_keep
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 2  # boxes, valid
            + [ctypes.c_int] * 2  # B, N
            + [ctypes.c_float]  # threshold
            + [ctypes.c_void_p] * 2  # keep, stream
        )
        lib.tf_nms_shape.restype = ctypes.c_int
        lib.tf_nms_shape.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
        _fn = fn
    return _fn


def launch_geometry(b: int, n: int, device: torch.device) -> dict:
    """The launch N1 makes on `device` (a CUDA device) for b images of n
    candidates, as the library computes it (tf_nms_shape): blocks a
    cluster, threads a block, rows staged in shared memory and the shared
    memory a block may opt in to. launch_shape and smem_rows are its
    hand-counted copies."""
    from tinyfaces_tpu_torch.utils.cuda_build import load_library

    _kernel()  # builds the library and sets tf_nms_shape's types
    fn = load_library("nms").tf_nms_shape
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = fn(b, n, *[ctypes.byref(x) for x in out])
    if err != 0:
        raise RuntimeError(f"tf_nms_shape failed: cudaError {err}")
    return dict(zip(("cluster", "threads", "staged_rows", "smem_optin"), (x.value for x in out)))


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """N1's keep mask of rank-sorted CUDA tensors, launched on the current
    stream in launch_shape(B)."""
    if not boxes.is_cuda:
        raise ValueError(f"N1 runs on CUDA tensors; boxes are on {boxes.device}")
    if valid.device != boxes.device:
        raise ValueError(f"valid on {valid.device}, boxes on {boxes.device}")
    b, n = valid.shape
    if boxes.shape != (b, n, 4) or boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"N1 takes (B, N, 4) float32 boxes and (B, N) bool validity; got "
                         f"{tuple(boxes.shape)} {boxes.dtype} and {tuple(valid.shape)} {valid.dtype}")
    if n > MAX_N:
        raise ValueError(f"N1 takes N <= {MAX_N} candidates an image (its lists hold 16-bit "
                         f"row numbers); got N={n}")
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    boxes, valid = boxes.contiguous(), valid.contiguous()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _kernel()(boxes.data_ptr(), valid.data_ptr(), b, n, float(iou_threshold), keep.data_ptr(),
                        stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    graphs.count_launch("n1")
    return keep
