"""Time the port's shipped b1 training step and eval frame on the card.

The canonical configuration at full width (chip_smoke.py's: 512^2,
texture 512^2 x 24 with 4 mips, SH lmax 10, 13 + 13 rays, U-Net nf0 64 / 5
downs, GCN 20 blocks k=16 on 7,500 vertices, the shipped knobs), seeded
weights, the synthetic G-buffer batch.  After warm-up it times --steps
train steps and --frames eval frames (cached v_feature), each by CUDA
events around the call, and prints one JSON line: medians, ranges, the
card's name and power limit, and the tree timed.

    python tools/time_step_frame.py                  # this checkout
    python tools/time_step_frame.py --root build/parent

--root names the checkout whose rnr_tpu_torch is imported (and whose
kernels are built, under its own build/), so that a parent and a change
can be timed in turns in one call: parent, change, change, parent.  It
uses only entry points both trees share.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are the card's")
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import (build_batch, build_config,
                                         build_statics, init_weights,
                                         to_torch)
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_eval_step,
                                           make_rnr_train_step)
    dev = torch.device("cuda", 0)
    cfg = build_config(img_size=512, tex_size=512, lmax=10, nf0=64,
                       num_down=5, gcn_blocks=20, num_azi=6, num_polar=2,
                       num_sample=4096)
    model = init_weights(RNRModel(cfg, 7500), seed=0)
    b = to_torch(build_batch(512, 7500, 1), dev)
    statics = build_statics(model, 4096)
    step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
    gen = make_generator(0)

    def times(fn, n):
        for _ in range(3):
            fn()
        out = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            z.record()
            z.synchronize()
            out.append(a.elapsed_time(z))
        return out

    t0 = time.perf_counter()
    step_ms = times(lambda: step(b, statics, gen), args.steps)
    eval_step = make_rnr_eval_step(model)
    with torch.inference_mode():
        vf = model.compute_v_feature(b["gcn_pos"])
    frame_ms = times(lambda: eval_step(b, v_feature=vf), args.frames)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "root": root, "card": smi,
        "step_ms": dict(median=float(np.median(step_ms)),
                        min=min(step_ms), max=max(step_ms), n=len(step_ms)),
        "frame_ms": dict(median=float(np.median(frame_ms)),
                         min=min(frame_ms), max=max(frame_ms),
                         n=len(frame_ms)),
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
