"""Load the JAX model's variables into the port.

Input: rnr_tpu's variable collections as nested dicts of numpy arrays
(`{"params": ..., "spectral": ..., "constants": ...}`, what
`jax.device_get(model.init(...))` gives).  The port's modules carry the
flax names, so a torch parameter `a.b.Dense_0.weight` reads flax
`params/a/b/Dense_0/kernel`, with the layout change of its module:

- `nn.Linear.weight` (flax Dense): [in, out] transposed;
- `SNDense.u`: from the `spectral` collection;
- everything else as is: `Conv.kernel` and `ConvTranspose.kernel` keep
  flax's HWIO layout under every conv_backend (the kernels and the plain
  convs read the same tensor), and BatchActNorm / GroupNorm scale and
  bias, textures, coeff, SNDense kernel/bias and biases are copied.
`constants` holds what `CONSTANT_BUFFERS` names: `LightingLP`'s probes
`lps` are copied; `LightingSH`'s basis caches `basis_val` and
`basis_val_recon` the port computes itself, and they are held to the JAX
values (to 1e-4 of the larger of their largest magnitude and 1).
`jax_grads_to_torch` maps a JAX gradient tree (the `params` structure)
into the port's parameter names and layouts by the same rules.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from rnr_tpu_torch.models.gcn import SNDense

# buffers that mirror a leaf of the JAX `constants` collection: copied, or
# computed by the port and checked against the JAX value
CONSTANT_BUFFERS = {"lps": "copy", "basis_val": "check",
                    "basis_val_recon": "check"}


def _lookup(tree: dict, path: list[str]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError("/".join(path))
        node = node[p]
    return np.asarray(node)


def _leaf_paths(tree: dict, prefix=()) -> set[tuple]:
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


def _convert(mod: nn.Module, leaf: str, variables: dict, path: list[str]):
    """(flax collection, flax path, array in the torch layout)."""
    params = variables["params"]
    if isinstance(mod, SNDense) and leaf == "u":
        return "spectral", path + ["u"], _lookup(variables["spectral"],
                                                 path + ["u"])
    if isinstance(mod, nn.Linear) and leaf == "weight":
        return "params", path + ["kernel"], _lookup(
            params, path + ["kernel"]).T
    return "params", path + [leaf], _lookup(params, path + [leaf])


def _load_constants(model: nn.Module, consts: dict, used: set) -> None:
    """The `CONSTANT_BUFFERS` of `model` from the JAX constants: copy the
    probes, hold the basis caches to the port's own.  Without constants
    (a tree of params only) the basis caches are not compared."""
    for name, buf in model.named_buffers():
        *mod_path, leaf = name.split(".")
        how = CONSTANT_BUFFERS.get(leaf)
        if how is None or (how == "check" and not consts):
            continue
        path = mod_path + [leaf]
        arr = _lookup(consts, path)
        if tuple(arr.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: JAX constants/{'/'.join(path)} has "
                             f"shape {arr.shape}, torch {tuple(buf.shape)}")
        if how == "copy":
            buf.copy_(torch.from_numpy(np.array(arr)))
        else:
            err = float(np.abs(buf.cpu().numpy() - arr).max())
            if not err <= 1e-4 * max(float(np.abs(arr).max()), 1.0):
                raise ValueError(f"{name}: the port's values differ from "
                                 f"JAX's by up to {err}")
        used.add(tuple(path))


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy every parameter (and SNDense `u`) of `model` from the JAX
    variables, and the `CONSTANT_BUFFERS`; raises if one is missing, has
    another shape, or if a JAX parameter or constant is left unused."""
    modules = dict(model.named_modules())
    used: dict[str, set] = {"params": set(), "spectral": set(),
                            "constants": set()}
    targets = list(model.named_parameters()) + [
        (n, b) for n, b in model.named_buffers() if n.endswith(".u")]
    for name, tensor in targets:
        *mod_path, leaf = name.split(".")
        mod = modules[".".join(mod_path)]
        coll, fpath, arr = _convert(mod, leaf, variables, mod_path)
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: JAX {'/'.join(fpath)} has shape "
                             f"{arr.shape}, torch {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.array(arr)))   # a fresh C-order copy
        used[coll].add(tuple(fpath))
    _load_constants(model, variables.get("constants", {}), used["constants"])
    for coll in ("params", "spectral", "constants"):
        left = _leaf_paths(variables.get(coll, {})) - used[coll]
        if left:
            raise ValueError(f"JAX {coll} not loaded: "
                             f"{sorted('/'.join(p) for p in left)}")
    return model


def jax_grads_to_torch(model: nn.Module, grads: dict) -> dict:
    """{parameter name: tensor} of the JAX gradient tree `grads` (the
    structure of `params`), each in the layout of the port's parameter."""
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        *mod_path, leaf = name.split(".")
        _, fpath, arr = _convert(modules[".".join(mod_path)], leaf,
                                 {"params": grads}, mod_path)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX grad {'/'.join(fpath)} has shape "
                             f"{arr.shape}, torch {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(arr))
    return out
