"""Quality gate of the port (counterpart of tools/quality_gate.py): the
real driver pipeline, make_scene -> precompute -> stitch_lp -> train_rnr,
trained for --iters iterations per arm, one validation with relighting
at the end, and each arm's final loss and validation metrics.

An arm is a set of train_rnr flags (ABLATIONS, copied flag for flag from
rnr_tpu's gate; "ship" resolves tools/out/best_config.json by the rules
of bench.py's resolve_tuned_config).  Each arm trains in a process of
its own, so that a crashed arm spares the others, under a log root named
by a hash of the gate's config: an arm whose summary.json exists is not
trained again, and a later call resumes the others.  Each arm's entry
holds rnr_tpu's keys (first_loss, last_loss, iters, val with its final_*
keys) and the port's: the card ("device", nvidia-smi's name and power
limit), iterations/s (train_rnr's summary.json "timing"), peak device
MiB, peak host RSS MiB and the memory samples of the arm's run.
`compare` holds a result to rnr_tpu's (tools/out/
quality_gate_canonical_r5.json) within TOLERANCES.

Usage:
  python -m rnr_tpu_torch.tools.quality_gate --canonical --img 512 \\
      --iters 2000 --ablations ship,r5_fast,r5_fast_seed1,exact,conv_slab3 \\
      --out tools/out/quality_gate_torch_canonical.json
  python -m rnr_tpu_torch.tools.quality_gate --platform cpu --iters 4 \\
      --img 32 --ablations ship,exact --out /tmp/gate.json
  python -m rnr_tpu_torch.tools.quality_gate \\
      --out tools/out/quality_gate_torch_canonical.json \\
      --compare tools/out/quality_gate_canonical_r5.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TUNED_PATH = ROOT / "tools" / "out" / "best_config.json"

# the arms of rnr_tpu's gate (tools/quality_gate.py), flag for flag.  The
# port has no ApproxTopK: --knn_recall is accepted and has no effect
# (its kNN ranks bf16 distances exactly, models/gcn.py)
ABLATIONS = {
    "default_strat": ["--knn_approx", "true", "--knn_recall", "0.9",
                      "--strat_min_dilation", "3"],
    "approx_windowed": ["--knn_approx", "true", "--knn_recall", "0.9",
                        "--strat_min_dilation", "0"],
    "exact": ["--knn_approx", "false", "--strat_min_dilation", "0"],
    "strat_refresh4": ["--knn_approx", "true", "--knn_recall", "0.9",
                       "--strat_min_dilation", "3",
                       "--graph_refresh_every", "4"],
    "rays_bf16": ["--knn_approx", "true", "--knn_recall", "0.9",
                  "--strat_min_dilation", "3",
                  "--rays_dtype", "bfloat16"],
    "unet_f32": ["--knn_approx", "true", "--knn_recall", "0.9",
                 "--strat_min_dilation", "3",
                 "--unet_compute_dtype", "float32"],
    "conv_pallas": ["--knn_approx", "true", "--knn_recall", "0.9",
                    "--strat_min_dilation", "3",
                    "--unet_conv_backend", "pallas"],
    "r3_fast": ["--knn_approx", "true", "--knn_recall", "0.9",
                "--strat_min_dilation", "3",
                "--rays_dtype", "bfloat16",
                "--unet_conv_backend", "pallas"],
    "gcn_norm_batch": ["--knn_approx", "true", "--knn_recall", "0.9",
                       "--strat_min_dilation", "3",
                       "--norm_type", "batch"],
    "conv_slab3": ["--knn_approx", "true", "--knn_recall", "0.9",
                   "--strat_min_dilation", "3",
                   "--rays_dtype", "bfloat16",
                   "--unet_conv_backend", "slab3"],
    "sh_fan_off": ["--knn_approx", "true", "--knn_recall", "0.9",
                   "--strat_min_dilation", "3",
                   "--rays_dtype", "bfloat16",
                   "--sh_fan_fuse", "false"],
    "r5_fast": ["--knn_approx", "true", "--knn_recall", "0.9",
                "--strat_min_dilation", "3",
                "--rays_dtype", "bfloat16"],
    "r5_fast_seed1": ["--knn_approx", "true", "--knn_recall", "0.9",
                      "--strat_min_dilation", "3",
                      "--rays_dtype", "bfloat16", "--seed", "1"],
    "rays_f32": ["--knn_approx", "true", "--knn_recall", "0.9",
                 "--strat_min_dilation", "3",
                 "--rays_dtype", "float32"],
}

# final metric: its least tolerance; each is widened to SPREAD_FACTOR x
# the seed spread |r5_fast - r5_fast_seed1|, the larger of the two results'
TOLERANCES = {"final_psnr": 0.10, "final_ssim": 0.03,
              "final_relight_psnr": 0.5}
SPREAD_FACTOR = 3.0
SEED_ARMS = ("r5_fast", "r5_fast_seed1")
# last_loss: within this share of the reference's
LOSS_REL = 0.10
# seconds between two memory samples of an arm's run
MEMORY_PERIOD_S = 10.0


def resolve_tuned_config(path: str | os.PathLike = TUNED_PATH) -> dict:
    """The shipped knobs by the rules of bench.py's resolve_tuned_config:
    best_config.json's values (a missing or unreadable file gives
    none), each overridden by its BENCH_* variable, then held to a
    whitelist (a typo'd value takes the default)."""
    tuned: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                tuned = json.load(f)
        except Exception:
            tuned = {}
    resolved = {
        "conv_backend": os.environ.get(
            "BENCH_CONV_BACKEND", tuned.get("conv_backend", "xla")),
        "rays_dtype": os.environ.get(
            "BENCH_RAYS_DTYPE", tuned.get("rays_dtype", "float32")),
        "gcn_dtype": os.environ.get(
            "BENCH_GCN_DTYPE", tuned.get("gcn_dtype", "float32")),
        "sh_fan_fuse": os.environ.get(
            "BENCH_SH_FAN", str(tuned.get("sh_fan_fuse", True))),
        "graph_refresh_every": os.environ.get(
            "BENCH_GCN_REFRESH", str(tuned.get("graph_refresh_every", 1))),
    }
    valid = {
        "conv_backend": {"auto", "xla", "pallas", "pallas3", "slab3",
                         "slab", "p3s4"},
        "rays_dtype": {"float32", "bfloat16"},
        "gcn_dtype": {"float32", "bfloat16"},
    }
    defaults = {"conv_backend": "xla", "rays_dtype": "float32",
                "gcn_dtype": "float32"}
    for k, allowed in valid.items():
        if resolved[k] not in allowed:
            resolved[k] = defaults[k]
    fan = str(resolved["sh_fan_fuse"]).lower()
    resolved["sh_fan_fuse"] = fan not in ("false", "0")
    try:
        refresh = int(resolved["graph_refresh_every"])
    except (TypeError, ValueError):
        refresh = 1
    resolved["graph_refresh_every"] = refresh if 1 <= refresh <= 20 else 1
    return resolved


def resolve_ablation(tag: str,
                     tuned_path: str | os.PathLike = TUNED_PATH) -> list:
    """Arm tag -> train_rnr flags; "ship" is the shipped knobs
    (resolve_tuned_config)."""
    if tag != "ship":
        return ABLATIONS[tag]
    tuned = resolve_tuned_config(tuned_path)
    return ["--knn_approx", "true", "--knn_recall", "0.9",
            "--strat_min_dilation", "3",
            "--rays_dtype", tuned["rays_dtype"],
            "--gcn_compute_dtype", tuned["gcn_dtype"],
            "--unet_conv_backend", tuned["conv_backend"],
            "--sh_fan_fuse", str(tuned["sh_fan_fuse"]).lower(),
            "--graph_refresh_every", str(tuned["graph_refresh_every"])]


def _latest_run(log_root: str):
    """(run dir, summary) of the newest run under log_root that wrote
    summary.json, or (None, None)."""
    if not os.path.isdir(log_root):
        return None, None
    for run in sorted(os.listdir(log_root), reverse=True):
        p = os.path.join(log_root, run, "summary.json")
        if os.path.isfile(p):
            with open(p) as f:
                return os.path.join(log_root, run), json.load(f)
    return None, None


def _gate_cfg(args) -> dict:
    # rnr_tpu's config, key for key: the same hash names the same arm
    return {"iters": args.iters, "img": args.img,
            "canonical": bool(args.canonical),
            "platform": args.platform, "relight": "lp_fit"}


def _arm_log_root(root: str, tag: str, cfg: dict) -> str:
    """Per-arm log dir, namespaced by a hash of the gate config: a
    summary left by a run of another config does not resume the arm."""
    canon = json.dumps(cfg, sort_keys=True)
    h = hashlib.sha256(canon.encode()).hexdigest()[:8]
    return os.path.join(root, f"logs_{tag}_{h}")


def arm_cfg(args, tag: str) -> dict:
    """The config an arm's log root hashes: the gate's, and for "ship"
    its flags (a changed best_config.json trains again instead of
    resuming)."""
    cfg = _gate_cfg(args)
    if tag == "ship":
        cfg = dict(cfg, ship_flags=resolve_ablation("ship"))
    return cfg


def card_info() -> str | None:
    """nvidia-smi's "name, power.limit" of the first card, or None where
    there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _rss_mib() -> float:
    """This process's resident set in MiB (Linux's /proc/self/statm)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


class MemoryWatch:
    """Samples [seconds, host RSS MiB, device MiB allocated] every
    `period` seconds on a thread, from start to stop: growth over a run
    shows as a rising column."""

    def __init__(self, cuda: bool, period: float = MEMORY_PERIOD_S):
        self.cuda, self.period = cuda, period
        self.samples: list = []
        self._stop = threading.Event()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        import torch
        dev = torch.cuda.memory_allocated() / 2 ** 20 if self.cuda else None
        self.samples.append([round(time.perf_counter() - self._t0, 3),
                             round(_rss_mib(), 3),
                             None if dev is None else round(dev, 3)])

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def run_arm(tag: str, train_args: list, log_root: str) -> str:
    """Train one arm in this process (train_rnr.main) and write its
    gate_arm.json beside its summary.json: the card, train_rnr.main's
    seconds (host clock), peak device MiB (over the arm: the peak is
    reset first), peak host RSS MiB (this process's) and the memory
    samples.  Returns the run dir."""
    import torch
    from rnr_tpu_torch.drivers import train_rnr
    platform = (train_args[train_args.index("--platform") + 1]
                if "--platform" in train_args else "cuda")
    cuda = platform == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with MemoryWatch(cuda) as watch:
        log_dir, model = train_rnr.main(train_args + ["--logging_root",
                                                      log_root]
                                        + resolve_ablation(tag))
    main_s = time.perf_counter() - t0
    del model
    extra = {"device": card_info() if cuda else "cpu", "main_s": main_s,
             "peak_device_mib": (torch.cuda.max_memory_allocated() / 2 ** 20
                                 if cuda else None),
             "peak_rss_mib": resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 1024,
             "memory": {"period_s": MEMORY_PERIOD_S,
                        "columns": ["s", "rss_mib", "device_mib"],
                        "samples": watch.samples}}
    with open(os.path.join(log_dir, "gate_arm.json"), "w") as f:
        json.dump(extra, f)
    print(f"arm {tag}: peak device {extra['peak_device_mib']} MiB, peak "
          f"RSS {extra['peak_rss_mib']:.1f} MiB on {extra['device']}",
          flush=True)
    return log_dir


def arm_entry(log_root: str) -> dict:
    """An arm's entry: its newest summary.json (rnr_tpu's keys and
    "timing") with iters_per_s and gate_arm.json's keys, or an error."""
    run, summary = _latest_run(log_root)
    if summary is None:
        return {"error": "no summary.json (arm crashed)"}
    entry = dict(summary)
    entry["iters_per_s"] = summary.get("timing", {}).get("iters_per_s")
    extra = os.path.join(run, "gate_arm.json")
    if os.path.isfile(extra):
        with open(extra) as f:
            entry.update(json.load(f))
    return entry


def _as_data(x):
    if isinstance(x, (str, os.PathLike)):
        with open(x) as f:
            return json.load(f)
    return x


def _seed_spread(results: dict, metric: str):
    a, b = (results.get(t, {}).get("val", {}).get(metric) for t in SEED_ARMS)
    return None if a is None or b is None else abs(a - b)


def compare(port, reference, tol: dict | None = None) -> dict:
    """Each arm of `port` against the same arm of `reference` (gate
    results as dicts or JSON paths): per final metric of `tol` (default
    TOLERANCES) the delta port - reference and the limit max(tol,
    SPREAD_FACTOR x the seed spread, the larger of the two results'),
    last_loss's relative delta against LOSS_REL; verdict "pass" where
    every delta is within its limit, "miss" where one is not, "no
    reference" / "error" where a side lacks the arm or its metrics."""
    port, reference = _as_data(port), _as_data(reference)
    tol = TOLERANCES if tol is None else tol
    spreads, limits = {}, {}
    for m, least in tol.items():
        found = [s for s in (_seed_spread(port, m),
                             _seed_spread(reference, m)) if s is not None]
        spreads[m] = max(found) if found else None
        limits[m] = max(least, SPREAD_FACTOR * (spreads[m] or 0.0))
    arms = {}
    for tag, got in port.items():
        want = reference.get(tag)
        if want is None or "val" not in want:
            arms[tag] = {"verdict": "no reference"}
            continue
        if "val" not in got or got.get("last_loss") is None:
            arms[tag] = {"verdict": "error"}
            continue
        row = {"metrics": {}}
        ok = True
        for m, limit in limits.items():
            d = got["val"][m] - want["val"][m]
            within = abs(d) <= limit
            ok &= within
            row["metrics"][m] = {"port": got["val"][m],
                                 "reference": want["val"][m], "delta": d,
                                 "limit": limit, "within": within}
        rel = (got["last_loss"] - want["last_loss"]) / want["last_loss"]
        within = abs(rel) <= LOSS_REL
        ok &= within
        row["metrics"]["last_loss"] = {
            "port": got["last_loss"], "reference": want["last_loss"],
            "delta": rel, "limit": LOSS_REL, "within": within,
            "relative": True}
        row["verdict"] = "pass" if ok else "miss"
        arms[tag] = row
    return {"seed_spread": spreads, "limits": limits, "arms": arms}


def print_comparison(res: dict) -> None:
    print("limits: " + ", ".join(f"{m} {v:.4g}"
                                 for m, v in res["limits"].items())
          + " (seed spread: " + ", ".join(
              f"{m} {'n/a' if v is None else f'{v:.4g}'}"
              for m, v in res["seed_spread"].items()) + ")")
    for tag, row in res["arms"].items():
        cells = [f"{m} {c['port']:.4f} vs {c['reference']:.4f} "
                 f"(d {c['delta']:+.4f}{' rel' if c.get('relative') else ''}"
                 f", limit {c['limit']:.3g})"
                 for m, c in row.get("metrics", {}).items()]
        print(f"{tag}: {row['verdict']}; " + "; ".join(cells))
    print("QUALITY_GATE_COMPARE", json.dumps(res))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--root", type=str, default=None)
    # train exactly one arm in this process (the parent's child)
    ap.add_argument("--one_arm", type=str, default=None)
    # incremental output: the arms merged into the file as each ends
    ap.add_argument("--out", type=str, default=None)
    # the shipped model sizes: texture 512 / 24 ch / 4 mips, SH lmax 10,
    # nf0 64 x 5 downs, GCN 20 blocks k=16 on a ~7.7k-vertex sphere
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--ablations", type=str,
                    default="default_strat,approx_windowed,exact,"
                            "strat_refresh4")
    # forwarded to precompute and train_rnr (their default: cuda)
    ap.add_argument("--platform", type=str, default=None)
    # the port's: hold --out to this result (rnr_tpu's) and train nothing
    ap.add_argument("--compare", type=str, default=None)
    return ap


def train_args(args, root: str) -> list:
    """train_rnr's flags of every arm (tools/quality_gate.py's)."""
    if args.canonical:
        size_args = [
            "--texture_size", "512", "--mipmap_level", "4",
            "--nf0", "64", "--n_blocks", "20", "--n_filters", "64",
            "--kernel_size", "16", "--out_channels_gcn", "512",
            "--sh_lmax", "10",
        ]
    else:
        size_args = [
            "--texture_size", "128", "--mipmap_level", "3",
            "--nf0", "32", "--n_blocks", "8", "--n_filters", "32",
            "--kernel_size", "8", "--out_channels_gcn", "128",
            "--sh_lmax", "4",
        ]
    return [
        "--data_root", root, "--obj_high_fp", "_/mesh.obj",
        "--obj_low_fp", "_/mesh.obj", "--obj_gcn_fp", "_/mesh.obj",
        "--img_size", str(args.img), *size_args,
        "--sphere_samples_fp", "nonexistent.mat",
        # every arm's validation also scores relighting against rgb1/
        "--lighting_idx", "0", "--lighting_relight_idx", "1",
        # the probe files: LightingLP.fit_sh starts every lighting index
        "--lp_dir", "_/lp",
        "--max_iter", str(args.iters),
        # one validation, at the last iteration
        "--val_freq", str(args.iters - 1),
        "--ckp_freq", "1000000", "--log_freq", "200",
        "--sampling_pattern", "skipinv_4",
        "--sampling_pattern_val", "only_0",
        *(["--platform", args.platform] if args.platform else []),
    ]


def prepare_scene(args, root: str) -> None:
    """The scene (24 views), its G-buffers and the stitched probe, unless
    root already holds them."""
    from rnr_tpu_torch.data.scene import make_scene
    from rnr_tpu_torch.drivers import precompute, stitch_lp
    if os.path.isdir(os.path.join(root, "rgb0")):
        return
    # dense enough that the stratified kNN engages (V >= kernel_size x
    # stratum width); canonical: a 7,665-vertex sphere (the reference's
    # mesh_7500v)
    if args.canonical:
        make_scene(root, num_view=24, hw=args.img, n_lat=72, n_lon=104)
    else:
        make_scene(root, num_view=24, hw=args.img, n_lat=24, n_lon=36)
    precompute.main(["--data_root", root, "--img_size", str(args.img),
                     "--sampling_pattern", "all",
                     *(["--platform", args.platform] if args.platform
                       else [])])
    stitch_lp.main(["--data_root", root, "--sampling_pattern", "skipinv_4",
                    "--img_suffix", ".png", "--lp_h", "128", "--lp_w",
                    "256"])


def _merge_out(path: str, results: dict) -> None:
    """`results` merged into the JSON file at `path` (a partial re-run
    updates its arms in place)."""
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f)
        except Exception:
            merged = {}
    merged.update(results)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, path)


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.compare:
        print_comparison(compare(args.out, args.compare))
        return {}
    root = os.path.abspath(args.root or tempfile.mkdtemp(prefix="rnr_qgate_"))
    print("scene root:", root, flush=True)
    prepare_scene(args, root)
    common = train_args(args, root)
    if args.one_arm:
        tag = args.one_arm
        print(f"=== {tag} ===", flush=True)
        run_arm(tag, common, _arm_log_root(root, tag, arm_cfg(args, tag)))
        return {}

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    results = {}
    for tag in args.ablations.split(","):
        log_root = _arm_log_root(root, tag, arm_cfg(args, tag))
        if _latest_run(log_root)[1] is None:
            cmd = [sys.executable, "-m", "rnr_tpu_torch.tools.quality_gate",
                   "--one_arm", tag, "--root", root,
                   "--iters", str(args.iters), "--img", str(args.img),
                   "--ablations", args.ablations]
            if args.canonical:
                cmd.append("--canonical")
            if args.platform:
                cmd += ["--platform", args.platform]
            rc = subprocess.run(cmd, env=env).returncode
            if rc != 0:
                print(f"arm {tag} exited rc={rc}", flush=True)
        results[tag] = arm_entry(log_root)
        if args.out:
            _merge_out(args.out, results)
    print("QUALITY_GATE", json.dumps(results))
    return results


if __name__ == "__main__":
    main()
