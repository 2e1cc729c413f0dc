"""Fused dense-IoU ground-truth assignment: CUDA kernel and its plain twin.

Counterpart of tinyfaces_tpu/ops/pallas_assignment.py. The reductions over
the perturbed (Y, X, T, G) IoU tensor — best GT per anchor, best anchor per
GT — run in the hand-written Hopper kernel `csrc/dense_assignment.cu`, which
never stores that tensor (~915 MB at B=12, 63x63x25, G=192).
`dense_assignment_reductions_reference` is the plain PyTorch version that
materializes it; the CPU runs and the kernel's checks use it.

Dispatch follows the tensors' device: CUDA tensors launch the kernel, CPU
tensors take the twin. A kernel that fails to build or launch raises; there
is no fallback.

The kernel's tie-break noise is a Philox stream keyed by a per-image seed;
the twin's is `torch.rand` under a generator seeded the same way. Both are
1e-6 * U[0, 1), as in the reference (processor.py:193-195), and they only
decide anchors whose IoUs tie to within 1e-6.
"""

from __future__ import annotations

import ctypes

import torch

from tinyfaces_tpu_torch.ops.assignment import compose_targets
from tinyfaces_tpu_torch.ops.dense_overlap import compute_dense_overlap

MAX_GT = 512  # shared-memory bound of the kernel
NOISE_SCALE = 1e-6

# Number of kernel launches in this process; a run reads it to show that the
# main path went through the kernel.
launch_count = 0

_fn = None


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
    global launch_count
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
    launch_count += 1
    return best_iou, best_gt, pgt_max, pgt_idx


def dense_assignment_reductions_reference(
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
):
    """Plain twin: materializes the perturbed (B, Y, X, T, G) IoU. With
    `noise_tensor` given it is added as the perturbation (tests feed JAX's
    own draws); otherwise `noise` draws 1e-6 * U[0,1) per image from a
    generator seeded with that image's seed."""
    b, g, _ = gt_boxes.shape
    iou = compute_dense_overlap(ofx, ofy, stx, sty, vsx, vsy, templates,
                                gt_boxes.to(torch.float32), gt_valid)
    if noise_tensor is not None:
        iou = iou + noise_tensor.to(iou.device, torch.float32)
    elif noise:
        draws = []
        for s in seed.reshape(b).tolist():
            gen = torch.Generator(device=iou.device).manual_seed(int(s))
            draws.append(torch.rand(iou.shape[1:], generator=gen, device=iou.device))
        iou = iou + NOISE_SCALE * torch.stack(draws)
    pert = torch.where(gt_valid[:, None, None, None, :], iou, -1.0)

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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Class and regression maps for a batch; the reductions run on the
    tensors' device (kernel on CUDA, twin on CPU). Per-image noise seeds
    are drawn from `generator`. Returns (class_map, regress_map)."""
    b = gt_boxes.shape[0]
    vsy, vsx = pad_mask.shape[1:3]
    gt_boxes = gt_boxes.to(torch.float32)
    gt_valid = drop_degenerate(gt_boxes, gt_valid)
    gen_dev = generator.device if generator is not None else gt_boxes.device
    seed = torch.randint(0, 2**31 - 1, (b,), generator=generator, device=gen_dev,
                         dtype=torch.int32).to(gt_boxes.device)
    rf = dict(ofx=ofx, ofy=ofy, stx=stx, sty=sty)
    reductions = dense_assignment_reductions(
        gt_boxes, gt_valid, templates, seed, vsx=vsx, vsy=vsy,
        noise=noise, noise_tensor=noise_tensor, **rf)
    return compose_targets(*reductions, gt_boxes, gt_valid, pad_mask, templates,
                           pos_thresh=pos_thresh, neg_thresh=neg_thresh, **rf)
