"""Weight bridge between the JAX package's trees and the port's state_dict.

`from_jax(params, batch_stats)` takes the numpy trees that
`jax.device_get` returns for a `tinyfaces_tpu` TinyFacesDetector and gives
a state_dict of the port's TinyFacesDetector; `to_jax` is its exact
inverse. The mapping is the reverse of
tools/convert_torch_checkpoint.convert_state_dict:

  conv kernel (kh, kw, I, O) HWIO     <-> weight (O, I, kh, kw) OIHW
  BN scale/bias, mean/var             <-> weight/bias, running_mean/var
  score heads kernel/bias             <-> weight/bias
  score4_upsample kernel (4, 4, C)    <-> weight (C, 1, 4, 4) depthwise
  backbone/layer{s}_{i}/downsample_*  <-> model.layer{s}.{i}.downsample.{0,1}

`from_npz` and `from_reference_pth` read the JAX package's .npz export and
a reference PyTorch checkpoint into the same state_dict.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

_BLOCK = re.compile(r"layer(\d)_(\d+)")


def _torch_module(path: list[str]) -> str:
    """JAX module path -> torch module name."""
    if path[0] != "backbone":
        return ".".join(path)
    out = ["model"]
    for p in path[1:]:
        m = _BLOCK.fullmatch(p)
        if m:
            out += [f"layer{m.group(1)}", m.group(2)]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(p)
    return ".".join(out)


def _jax_module(name: str) -> list[str]:
    """torch module name -> JAX module path (inverse of _torch_module)."""
    parts = name.split(".")
    if parts[0] != "model":
        return parts
    out = ["backbone"]
    i = 1
    while i < len(parts):
        p = parts[i]
        if p.startswith("layer"):
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "downsample":
            out.append("downsample_conv" if parts[i + 1] == "0" else "downsample_bn")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _walk(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield list(prefix), k, np.asarray(v)


def from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """numpy {params, batch_stats} trees -> state_dict of float32 tensors."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf, w in _walk(params):
        mod = _torch_module(path)
        if path[0] == "score4_upsample":
            w = np.transpose(w, (2, 0, 1))[:, None]
        elif leaf == "kernel":
            w = np.transpose(w, (3, 2, 0, 1))
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[f"{mod}.{name}"] = torch.tensor(np.array(w, np.float32))
    for path, leaf, w in _walk(batch_stats):
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{_torch_module(path)}.{name}"] = torch.tensor(np.array(w, np.float32))
    return sd


def from_npz(path: str | Path) -> dict[str, torch.Tensor]:
    """state_dict from the JAX package's flat .npz export
    ({params, batch_stats} trees, utils/serialization.save_npz)."""
    from tinyfaces_tpu.utils.serialization import unflatten_npz

    with np.load(path) as npz:
        tree = unflatten_npz(npz)
    return from_jax(tree["params"], tree.get("batch_stats", {}))


def from_reference_pth(path: str | Path) -> dict[str, torch.Tensor]:
    """state_dict from a reference PyTorch checkpoint (a DetectionModel
    training checkpoint or a torchvision ResNet state_dict), converted by
    tools/convert_torch_checkpoint.py, which is loaded by its path."""
    tool = Path(__file__).resolve().parents[2] / "tools" / "convert_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("_convert_torch_checkpoint", tool)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    tree = module.convert_torch_checkpoint(path)
    return from_jax(tree["params"], tree["batch_stats"])


def to_jax(state_dict: dict) -> tuple[dict, dict]:
    """state_dict -> numpy (params, batch_stats) trees of the JAX model."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for name, t in state_dict.items():
        w = t.detach().cpu().numpy().astype(np.float32)
        mod, leaf = name.rsplit(".", 1)
        path = _jax_module(mod)
        if leaf in ("running_mean", "running_var"):
            put(stats, path + [leaf.removeprefix("running_")], w)
        elif path[0] == "score4_upsample":
            put(params, path + ["kernel"], np.transpose(w[:, 0], (1, 2, 0)))
        elif leaf == "weight" and w.ndim == 4:
            put(params, path + ["kernel"], np.transpose(w, (2, 3, 1, 0)))
        elif leaf == "weight":
            put(params, path + ["scale"], w)
        else:
            put(params, path + [leaf], w)
    return params, stats
