"""Fused dense-IoU ground-truth assignment: CUDA kernel and its plain twin.

Counterpart of tinyfaces_tpu/ops/pallas_assignment.py. The reductions over
the perturbed (Y, X, T, G) IoU tensor — best GT per anchor, best anchor per
GT — run in the hand-written Hopper kernel `csrc/dense_assignment.cu`, which
never stores that tensor (~915 MB at B=12, 63x63x25, G=192).
`dense_assignment_reductions_reference` is the plain PyTorch version that
materializes it; the CPU runs and the kernel's checks use it.

Dispatch follows the tensors' device: CUDA tensors launch the kernel, CPU
tensors take the twin. A kernel that fails to build or launch raises; there
is no fallback. Each launch counts as "k1" in utils/graphs.launches.

The tie-break noise is 1e-6 * U[0, 1), as in the reference
(processor.py:193-195); it only decides anchors whose IoUs tie to within
1e-6. The kernel draws it from a counter hash keyed by (image seed, flat
anchor index, original g); the twin's default is `torch.rand` under a
generator seeded with the image's seed. `kernel_noise` is the plain mirror
of the kernel's hash: fed to the twin as `noise_tensor`, it makes kernel and
twin agree at the value level with noise on. (The TPU kernel's draws come
from its on-core PRNG and cannot be reproduced; only their distribution is
shared.)
"""

from __future__ import annotations

import ctypes

import torch

from tinyfaces_tpu_torch.ops.assignment import compose_targets
from tinyfaces_tpu_torch.ops.dense_overlap import compute_dense_overlap
from tinyfaces_tpu_torch.utils import graphs

MAX_GT = 512  # shared-memory bound of the kernel
NOISE_SCALE = 1e-6

_fn = None

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), in 16-bit halves so that
    no product leaves int64."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kernel_noise_bits(seed: torch.Tensor, vsy: int, vsx: int, t: int, g: int) -> torch.Tensor:
    """The kernel's 24-bit tie-break draws, (B, vsy, vsx, t, g) int64:
    fmix32(fmix32(fmix32(seed ^ C0) ^ a) + g * C1) >> 8 for image seed
    `seed[b]`, flat anchor index a = (y * vsx + x) * t + t_i and original GT
    index g, all in uint32 arithmetic."""
    dev = seed.device
    anchors = torch.arange(vsy * vsx * t, dtype=torch.int64, device=dev)
    gkey = _mul32(torch.arange(g, dtype=torch.int64, device=dev), 0x9E3779B9)
    out = []
    for s in _fmix32((seed.to(torch.int64).reshape(-1) & _M32) ^ 0x7F4A7C15):
        akey = _fmix32(s ^ anchors)
        out.append((_fmix32((akey[:, None] + gkey[None, :]) & _M32) >> 8).reshape(vsy, vsx, t, g))
    return torch.stack(out)


def kernel_noise(seed: torch.Tensor, vsy: int, vsx: int, t: int, g: int) -> torch.Tensor:
    """The kernel's tie-break noise, (B, vsy, vsx, t, g) float32 in
    [0, 1e-6): the 24-bit draws times 2^-24 times 1e-6, rounded once, as
    the kernel does."""
    unit = torch.tensor(NOISE_SCALE * 2.0**-24, dtype=torch.float32, device=seed.device)
    return kernel_noise_bits(seed, vsy, vsx, t, g).to(torch.float32) * unit


def valid_pairs(gt_valid: torch.Tensor, vsy: int, vsx: int, t: int) -> int:
    """(anchor, valid GT) pairs of a batch: the kernel's work."""
    return int(gt_valid.to(torch.bool).sum()) * vsy * vsx * t


def k1_bound(gt_valid: torch.Tensor, vsy: int, vsx: int, t: int) -> tuple[float, str]:
    """Least time of the kernel on an H100 SXM for these inputs (ms) and
    what bounds it: ~15 fp32 operations (the +1-convention IoU, its
    division, the noise scale) per valid anchor-GT pair at 67 TFLOP/s,
    against the bytes read once (GT, valid, templates, seeds) and written
    once (per-anchor max/argmax, per-GT max/argmax) at 3.35 TB/s."""
    b, g = gt_valid.shape
    ops_ms = 15.0 * valid_pairs(gt_valid, vsy, vsx, t) / 67e12 * 1e3
    nbytes = b * g * 16 + b * g + t * 16 + b * 4 + b * vsy * vsx * t * 8 + b * g * 8
    bytes_ms = nbytes / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _kernel():
    global _fn
    if _fn is None:
        from tinyfaces_tpu_torch.utils.cuda_build import load_library

        fn = load_library("dense_assignment").tf_dense_assignment
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4  # gt_boxes, gt_valid, templates, seeds
            + [ctypes.c_int] * 5  # B, G, T, Y, X
            + [ctypes.c_float] * 4  # ofx, ofy, stx, sty
            + [ctypes.c_int]  # noise
            + [ctypes.c_void_p] * 6  # best_iou, best_gt, pgt_max, pgt_idx, pgt_key, stream
        )
        _fn = fn
    return _fn


def _launch(gt_boxes, gt_valid, templates, seed, *, vsx, vsy, ofx, ofy, stx, sty, noise):
    dev = gt_boxes.device
    b, g, _ = gt_boxes.shape
    if not 1 <= g <= MAX_GT:
        raise ValueError(f"G={g} outside the kernel's range 1..{MAX_GT}")
    for name, t in (("gt_valid", gt_valid), ("templates", templates), ("seed", seed)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, gt_boxes on {dev}")
    boxes = gt_boxes.to(torch.float32).contiguous()
    valid = gt_valid.to(torch.bool).contiguous()
    tpl = templates[:, :4].to(torch.float32).contiguous()
    seeds = seed.to(torch.int32).reshape(b).contiguous()
    nt = tpl.shape[0]

    best_iou = torch.empty(b, vsy, vsx, nt, dtype=torch.float32, device=dev)
    best_gt = torch.empty(b, vsy, vsx, nt, dtype=torch.int32, device=dev)
    pgt_max = torch.empty(b, g, dtype=torch.float32, device=dev)
    pgt_idx = torch.empty(b, g, dtype=torch.int32, device=dev)
    pgt_key = torch.zeros(b, g, dtype=torch.int64, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            boxes.data_ptr(), valid.data_ptr(), tpl.data_ptr(), seeds.data_ptr(),
            b, g, nt, vsy, vsx, float(ofx), float(ofy), float(stx), float(sty), int(noise),
            best_iou.data_ptr(), best_gt.data_ptr(), pgt_max.data_ptr(),
            pgt_idx.data_ptr(), pgt_key.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_assignment kernel launch failed: cudaError {err}")
    graphs.count_launch("k1")
    return best_iou, best_gt, pgt_max, pgt_idx


def perturbed_iou(
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G) bool
    templates: torch.Tensor,  # (T, >=4)
    seed: torch.Tensor,  # (B,) int32
    *,
    vsx: int,
    vsy: int,
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    noise: bool = True,
    noise_tensor: torch.Tensor | None = None,  # (B, Y, X, T, G) perturbation
) -> torch.Tensor:
    """The (B, Y, X, T, G) tensor the reductions run over: IoU plus
    tie-break noise, -1 at invalid GTs. With `noise_tensor` given it is the
    perturbation (tests feed JAX's own draws, the kernel's checks
    `kernel_noise`); otherwise `noise` draws 1e-6 * U[0,1) per image from a
    generator seeded with that image's seed."""
    iou = compute_dense_overlap(ofx, ofy, stx, sty, vsx, vsy, templates,
                                gt_boxes.to(torch.float32), gt_valid)
    if noise_tensor is not None:
        iou = iou + noise_tensor.to(iou.device, torch.float32)
    elif noise:
        draws = []
        for s in seed.reshape(iou.shape[0]).tolist():
            gen = torch.Generator(device=iou.device).manual_seed(int(s))
            draws.append(torch.rand(iou.shape[1:], generator=gen, device=iou.device))
        iou = iou + NOISE_SCALE * torch.stack(draws)
    return torch.where(gt_valid[:, None, None, None, :], iou, -1.0)


def dense_assignment_reductions_reference(gt_boxes, gt_valid, templates, seed, **kw):
    """Plain twin: materializes `perturbed_iou` (same arguments) and reduces
    it."""
    pert = perturbed_iou(gt_boxes, gt_valid, templates, seed, **kw)
    b, g = pert.shape[0], pert.shape[-1]
    # torch.max(dim) returns the first index of the maximum, like jnp.argmax.
    best_iou, best_gt = pert.max(dim=4)
    pgt_max, pgt_idx = pert.reshape(b, -1, g).max(dim=1)
    return best_iou, best_gt.to(torch.int32), pgt_max, pgt_idx.to(torch.int32)


def dense_assignment_reductions(
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G) bool
    templates: torch.Tensor,  # (T, >=4)
    seed: torch.Tensor,  # (B,) int32
    *,
    vsx: int,
    vsy: int,
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    noise: bool = True,
    noise_tensor: torch.Tensor | None = None,
):
    """Returns (best_iou (B,Y,X,T) f32, best_gt (B,Y,X,T) i32, pgt_max (B,G)
    f32, pgt_idx (B,G) i32) over the perturbed IoU. CUDA tensors go to the
    kernel, CPU tensors to the twin."""
    kw = dict(vsx=vsx, vsy=vsy, ofx=ofx, ofy=ofy, stx=stx, sty=sty, noise=noise)
    if gt_boxes.is_cuda:
        if noise_tensor is not None:
            raise ValueError("noise_tensor is taken only by the reference twin")
        return _launch(gt_boxes, gt_valid, templates, seed, **kw)
    if gt_boxes.device.type != "cpu":
        raise ValueError(f"no dense-assignment path for device {gt_boxes.device}")
    return dense_assignment_reductions_reference(
        gt_boxes, gt_valid, templates, seed, noise_tensor=noise_tensor, **kw)


def drop_degenerate(gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """The reference drops zero- or negative-extent boxes before assignment
    (processor.py:225-230)."""
    degenerate = (gt_boxes[..., 2] <= gt_boxes[..., 0]) | (gt_boxes[..., 3] <= gt_boxes[..., 1])
    return gt_valid.to(torch.bool) & ~degenerate


def draw_seeds(generator: torch.Generator | None, n: int, device: torch.device) -> torch.Tensor:
    """K1's (n,) int32 per-image noise seeds from `generator` (on its
    device, or `device` without one)."""
    gen_dev = generator.device if generator is not None else device
    return torch.randint(0, 2**31 - 1, (n,), generator=generator, device=gen_dev,
                         dtype=torch.int32)


def assign_targets_fused(
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G) bool
    pad_mask: torch.Tensor,  # (B, Y, X, T) bool
    templates: torch.Tensor,  # (T, >=4)
    generator: torch.Generator | None,
    *,
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    pos_thresh: float,
    neg_thresh: float,
    noise: bool = True,
    noise_tensor: torch.Tensor | None = None,
    part: tuple[int, int] = (0, 1),
    seed: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Class and regression maps for a batch; the reductions run on the
    tensors' device (kernel on CUDA, twin on CPU). Per-image noise seeds
    are drawn from `generator` (draw_seeds), or given as `seed` (B,) int32.
    `part` = (rank, world): the batch is rank's rows of a global batch of
    world * B, so the seeds are drawn for the global batch and rank's rows
    kept, as world 1 draws them. Returns (class_map, regress_map)."""
    b = gt_boxes.shape[0]
    vsy, vsx = pad_mask.shape[1:3]
    gt_boxes = gt_boxes.to(torch.float32)
    gt_valid = drop_degenerate(gt_boxes, gt_valid)
    if seed is None:
        r, w = part
        seed = draw_seeds(generator, w * b, gt_boxes.device)[r * b:(r + 1) * b]
    seed = seed.to(gt_boxes.device)
    rf = dict(ofx=ofx, ofy=ofy, stx=stx, sty=sty)
    reductions = dense_assignment_reductions(
        gt_boxes, gt_valid, templates, seed, vsx=vsx, vsy=vsy,
        noise=noise, noise_tensor=noise_tensor, **rf)
    return compose_targets(*reductions, gt_boxes, gt_valid, pad_mask, templates,
                           pos_thresh=pos_thresh, neg_thresh=neg_thresh, **rf)
