"""Time K4 (csrc/stratified_knn.cu) and K2b (csrc/mipmap_scatter.cu) on
one NVIDIA GPU with parts of each kernel switched off, to see which part
bounds it.

    python3 chip_variants.py

Each variant is the real source with one textual switch applied, written
to build/rnr_tpu_torch/variants/ and built with the flags of
rnr_tpu_torch/ops/_build.py; its C entry is called 20 times back to back
between two CUDA events (device time per call, the host's hidden), at
the kernels phase's shapes of chip_smoke.py: K4 at V 7500 and C 64 and
512 on random features, K2b on the synthetic G-buffer's uv at 512^2 (b1),
on its object alone (the uncovered pixels moved off the texture) and with
every pixel on the corner texel, 4 levels x 24 channels.  Switched-off
variants compute wrong results: they are timed, never checked.

K4:  real; no_argmax (the products, then nothing: the epilogue's scores,
     argmax, merge and stores gone); no_stores (all but the index
     stores); no_pdl (the kernel launched after the first pass ends, not
     while it runs); no_products (the epilogue on accumulators set
     without wgmma).
K2b: real; no_atomics (every reduction into the gradient skipped);
     no_peel (where a tile's box overflows, every lane sends its own
     taps: no group summed first); no_sums (the per-tap work gone: no
     sort, no sums, no reductions);
     staging (the g rows and uv read, no level processed).
Prints one line per (kernel, case, variant) and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from rnr_tpu_torch.ops import _build  # noqa: E402
from rnr_tpu_torch.ops.knn_cuda import knn_work_bytes  # noqa: E402

OUT = os.path.join(ROOT, "build", "rnr_tpu_torch", "variants")

K4_VARIANTS = {
    "real": [],
    "no_argmax": [(
        "    item_epilogue(acc, sqs, q, rt * BM + wg * 64 + warp * 16 + lane / 4, v,\n"
        "                  ns, ct, out);\n", "")],
    "no_stores": [
        ("  if (i >= v) return;\n  const int s0 = ct * STRATUM + 4 * q;",
         "  if (i >= v || res[0] != -7) return;\n"
         "  const int s0 = ct * STRATUM + 4 * q;")],
    "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "no_products": [
        ("        chunk_products<true>(acc, a_ch, b_ch);",
         "        for (int i = 0; i < 128; ++i) acc[i] = __int_as_float(a_ch + i);"),
        ("        chunk_products<false>(acc, a_ch, b_ch);",
         "        for (int i = 0; i < 128; ++i) acc[i] += __int_as_float(b_ch + i);")],
}
K2B_VARIANTS = {
    "real": [],
    "no_atomics": [
        ("  atomicAdd(dst, a[0]);", "  if (a[0] == 1.2345e-30f) atomicAdd(dst, a[0]);"),
        ('  asm volatile("red.global.add.v4.f32',
         '  if (a[0] == 1.2345e-30f) asm volatile("red.global.add.v4.f32')],
    "no_peel": [("      for (int r = 0; r < 2; ++r) {",
                 "      for (int r = 0; r < 0; ++r) {")],
    "no_sums": [
        ("    if (ww <= WIN && wh <= WIN && ww * wh <= WIN) {",
         "    if (ww > 0) continue;\n    if (ww <= WIN && wh <= WIN && ww * wh <= WIN) {")],
    "staging": [
        ("  for (int l = 0; l < lv.n; ++l) {",
         "  if (u == 1.2345e-30f) gs[0] = vv;\n  for (int l = 0; l < 0; ++l) {")],
}


def build(src: str, name: str, switches) -> ctypes.CDLL:
    text = open(os.path.join(_build.CSRC, f"{src}.cu")).read()
    for old, new in switches:
        if old not in text:
            raise RuntimeError(f"{src} {name}: switch not found: {old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{src}_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = path[:-3] + ".so"
    res = subprocess.run([_build._nvcc(), *_build._flags(src), "-I",
                          str(_build.CSRC), "-o", so, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} {name}:\n{res.stderr}")
    for ln in res.stderr.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"[build] {src} {name}: {ln.strip()}", flush=True)
    return ctypes.CDLL(so)


def entry(lib, symbol: str, n_ptr: int, n_int: int):
    f = getattr(lib, symbol)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def device_us(call, n: int = 20) -> float:
    """Device time per call in us over n calls queued back to back."""
    for _ in range(3):
        if call() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    v = 7500
    for c in (64, 512):
        x = torch.from_numpy(np.random.default_rng(c).standard_normal(
            (v, c)).astype(np.float32)).to(dev)
        out = torch.empty((v, -(-v // 16)), dtype=torch.int32, device=dev)
        work = torch.empty(knn_work_bytes(v, c), dtype=torch.uint8,
                           device=dev)
        for name, switches in K4_VARIANTS.items():
            f = entry(build("stratified_knn", name, switches),
                      "rnr_stratified_knn", 3, 2)
            us = device_us(lambda: f(x.data_ptr(), out.data_ptr(),
                                     work.data_ptr(), v, c, stream))
            print(f"K4 V{v} C{c} {name}: {us:.2f} us per call "
                  f"({2 * v * v * c / us / 1e6:.1f} TFLOP/s)", flush=True)

    from rnr_tpu_torch.synthetic import build_batch
    uv = torch.from_numpy(build_batch(512, 16, 1)["uv_map"]).to(dev)
    covered = (uv != 0).any(-1, keepdim=True)
    cases = {"G-buffer uv": uv,
             "object alone": torch.where(covered, uv, torch.full_like(
                 uv, -1.0)).contiguous(),
             "every pixel on the corner": torch.zeros_like(uv)}
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 512, 512, 24)).astype(np.float32)).to(dev)
    sizes = (512, 256, 128, 64)
    grads = [torch.zeros((s, s, 24), device=dev) for s in sizes]
    for name, switches in K2B_VARIANTS.items():
        f = entry(build("mipmap_scatter", name, switches),
                  "rnr_mipmap_scatter", 6, 9)
        for tag, u in cases.items():
            us = device_us(lambda: f(*[t.data_ptr() for t in grads],
                                     u.data_ptr(), g.data_ptr(), *sizes, 4,
                                     1, 512, 512, 24, stream))
            print(f"K2b 512^2 x 4 levels x 24, {tag}, {name}: {us:.2f} us "
                  "per call", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
