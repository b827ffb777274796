"""Checkpoints (port of rnr_tpu/train/checkpoint.py).

The port's own format is `torch.save` of {"model": the model's
state_dict, "optimizer": the Adam state_dict, "step": int}, written to a
`.tmp` file and moved into place.

`load_checkpoint` also reads what rnr_tpu's `save_checkpoint` writes:
`flax.serialization.to_bytes` of its TrainState, a msgpack map of step,
params, constants, spectral and opt_state, each array a msgpack
extension (type 1: a packed (shape, dtype name, bytes); type 3: a numpy
scalar), arrays above 1 GiB split into chunks.  `unpackb` below decodes
it with no msgpack package.  The weights go in through
`convert.load_jax_variables` (params, spectral, constants); the Adam
moments of an rnr_tpu checkpoint are not carried across: the optimizer
keeps its own state (a fresh one when the run starts from that file).
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from rnr_tpu_torch.convert import load_jax_variables

ZIP_MAGIC = b"PK\x03\x04"   # torch.save's zip container


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int = 0) -> None:
    payload = {"model": model.state_dict(),
               "optimizer": None if optimizer is None
               else optimizer.state_dict(),
               "step": int(step)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# ------------------------------------------------------ msgpack decoding


def _array(payload: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(payload)
    name = dtype.decode() if isinstance(dtype, bytes) else dtype
    if name == "bfloat16":   # no numpy dtype: widen the bits to float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == 1:
        return _array(data)
    if code == 3:
        return _array(data)[()]
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if t in ints:
            return self.unpack(ints[t])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in (0xC4, 0xC5, 0xC6):      # bin
            return self.take(self.unpack(sizes[t]))
        if t in (0xD9, 0xDA, 0xDB):      # str
            return self.take(self.unpack(sizes[t])).decode()
        if t in (0xDC, 0xDD):            # array
            return [self.obj() for _ in range(self.unpack(sizes[t]))]
        if t in (0xDE, 0xDF):            # map
            return self.map(self.unpack(sizes[t]))
        if t in (0xC7, 0xC8, 0xC9):      # ext
            n = self.unpack(sizes[t])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if 0xD4 <= t <= 0xD8:            # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (t - 0xD4)))
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _unchunk(tree):
    """flax's chunked arrays ({"__msgpack_chunked_array__": True, "shape":
    {"0": ..}, "chunks": {"0": ..}}) joined back, everywhere in `tree`."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes):
    """Decode one msgpack object (flax's array extensions included)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - r.pos} bytes after the "
                         "object")
    return out


def read_flax_state(path: str) -> dict:
    """The state dict of an rnr_tpu checkpoint: step, params, constants,
    spectral and opt_state as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


# ---------------------------------------------------------------- loading


def _is_torch_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == ZIP_MAGIC


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> int:
    """Restore `model` (and `optimizer`, from the port's format) from
    either package's checkpoint in place; returns the saved step."""
    dev = next(model.parameters()).device
    if _is_torch_file(path):
        payload = torch.load(path, map_location=dev, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None and payload["optimizer"] is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return int(payload["step"])
    state = read_flax_state(path)
    load_jax_variables(model, {k: state.get(k, {}) for k in
                               ("params", "spectral", "constants")})
    return int(np.asarray(state.get("step", 0)))


def load_checkpoint_parts(path: str, model: torch.nn.Module,
                          parts: list[str]) -> int:
    """Restore only the parameters of the named parts (texture_mapper,
    render_net, gcn, lighting) and every buffer (the spectral vectors and
    the constants), the reference's custom_load semantics; the other
    parts' parameters keep their values."""
    keep = {n: p.detach().clone() for n, p in model.named_parameters()
            if n.split(".", 1)[0] not in parts}
    step = load_checkpoint(path, model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in keep:
                p.copy_(keep[n])
    return step
