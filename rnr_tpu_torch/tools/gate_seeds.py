"""The quality gate's shipped arm at more seeds, on the gate's scene.

How often does a seed land in each basin of the gate's objective?  This
trains the "ship" arm (tools/out/best_config.json's knobs) once a seed,
through train_rnr --seed as the gate's r5_fast_seed1 arm passes it, one
process a run, and writes each run's entry (quality_gate.arm_entry: the
final train-view PSNR, SSIM, relight PSNR, last loss, iterations/s,
memory) to --out as each ends.  It adds no arm to the gate, whose arms
are held to rnr_tpu's.

    python -m rnr_tpu_torch.tools.gate_seeds --canonical --img 512 \\
        --iters 2000 --seeds 2,3,4 --root build/gate \\
        --out tools/out/quality_gate_torch_seeds.json

--root is the gate's scene root (made there if absent); a seed whose run
left a summary.json under it is read, not trained again.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

from rnr_tpu_torch.tools import quality_gate as qg


def seed_log_root(args, root: str, seed: int) -> str:
    tag = f"ship_seed{seed}"
    return qg._arm_log_root(root, tag, dict(qg.arm_cfg(args, "ship"),
                                            seed=seed))


def main(argv=None) -> dict:
    ap = qg.build_argparser()
    ap.add_argument("--seeds", type=str, default="2,3,4")
    # train exactly one seed in this process (the parent's child)
    ap.add_argument("--one_seed", type=int, default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or tempfile.mkdtemp(prefix="rnr_qgate_"))
    qg.prepare_scene(args, root)
    common = qg.train_args(args, root)
    if args.one_seed is not None:
        seed = args.one_seed
        print(f"=== ship, seed {seed} ===", flush=True)
        qg.run_arm("ship", common + ["--seed", str(seed)],
                   seed_log_root(args, root, seed))
        return {}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(qg.ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
    results = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        log_root = seed_log_root(args, root, seed)
        if qg._latest_run(log_root)[1] is None:
            cmd = [sys.executable, "-m", "rnr_tpu_torch.tools.gate_seeds",
                   "--one_seed", str(seed), "--root", root,
                   "--iters", str(args.iters), "--img", str(args.img)]
            if args.canonical:
                cmd.append("--canonical")
            if args.platform:
                cmd += ["--platform", args.platform]
            rc = subprocess.run(cmd, env=env).returncode
            if rc != 0:
                print(f"seed {seed} exited rc={rc}", flush=True)
        results[f"ship_seed{seed}"] = dict(qg.arm_entry(log_root), seed=seed)
        if args.out:
            qg._merge_out(args.out, results)
    print("GATE_SEEDS", json.dumps(results))
    return results


if __name__ == "__main__":
    main()
