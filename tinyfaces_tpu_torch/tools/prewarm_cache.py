"""Build every native library the port uses ahead of a first run.

    python -m tinyfaces_tpu_torch.tools.prewarm_cache [--device cuda]

Port of tools/prewarm_cache.py. The JAX tool filled XLA's persistent
compilation cache, because a TPU program compiled for minutes the first
time. The port's only ahead-of-time builds are its native libraries, which
utils/cuda_build.py compiles at first use into build/torch_ext/ under the
hash of their source and flags (its cache: a later run loads them as they
are):

  * csrc/dense_assignment.cu, the K1 kernel (nvcc, sm_90a);
  * csrc/nms.cu, the N1 kernel, the pyramid's NMS (nvcc, sm_90a);
  * csrc/tinyfaces_native.cpp, the augmentation engine (host C++);
  * csrc/jpeg_dct.cpp, the JPEG entropy decoder and packers (host C++).

They build side by side, one compiler each. Prints each library, whether
it was compiled or already in the cache, and the seconds it took, then a
JSON line. `--device cpu` builds the two host libraries only (no nvcc).
PyTorch's own kernels need no build, and cuDNN's per-shape set-up happens
in a run's first step whatever is cached.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def builds(with_kernel: bool) -> dict:
    """{library name: loader} of the port's native libraries."""
    from tinyfaces_tpu_torch.data import jpegdct, native
    from tinyfaces_tpu_torch.ops import assignment_kernel, nms_kernel

    out = {"tinyfaces_native": native.load, "jpeg_dct": jpegdct.load}
    if with_kernel:
        out = {"dense_assignment": assignment_kernel._kernel, "nms": nms_kernel._kernel, **out}
    return out


def prewarm(with_kernel: bool) -> list[dict]:
    """Build (or load from the cache) every library, side by side: one row
    {"name", "compiled", "seconds", "library"} each."""
    from tinyfaces_tpu_torch.utils import cuda_build

    def one(name, load):
        before = set(cuda_build.BUILD_DIR.glob(f"lib{name}-*.so"))
        t0 = time.perf_counter()
        load()
        seconds = time.perf_counter() - t0
        library = Path(cuda_build._loaded[name]._name)
        return {"name": name, "compiled": library not in before, "seconds": seconds,
                "library": library.name}

    todo = builds(with_kernel)
    with ThreadPoolExecutor(len(todo)) as pool:
        return [f.result() for f in [pool.submit(one, n, f) for n, f in todo.items()]]


def main(argv=None) -> dict:
    from tinyfaces_tpu_torch.utils.instruments import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda builds the kernels too; cpu builds the host libraries only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rows = prewarm(dev.type == "cuda")
    for r in rows:
        print(f"{r['name']}: {'compiled' if r['compiled'] else 'cached'} in {r['seconds']:.2f} s "
              f"(build/torch_ext/{r['library']})", flush=True)
    out = {"libraries": rows, "wall_s": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
