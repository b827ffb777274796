"""The port's quality gate (rnr_tpu_torch/tools/quality_gate.py) against
rnr_tpu's (tools/quality_gate.py), its scene (rnr_tpu_torch/data/
scene.py) against tests/test_pipeline_e2e.py's, the port's scripts
against scripts/*.sh, and both packages' train_rnr over 40 iterations
from one checkpoint.  On the CPU; the port side needs no cv2.

(a) ABLATIONS flag for flag; resolve_ablation("ship") on the repo's
    best_config.json, on temporary ones and under each BENCH_* override
    (the cases of tests/test_bench_config.py), as rnr_tpu's through
    bench.py;
(b) _arm_log_root's directory for the same gate config;
(c) make_scene's files: mesh.obj, calib.mat, every view and probe;
(d) a tiny gate (--platform cpu --iters 4 --img 32, arms ship and
    exact) end to end as `python -m`-style subprocesses, its JSON with
    rnr_tpu's keys and the port's, and a second call that trains
    nothing; `compare` on the result and on rnr_tpu's canonical one;
(e) the trajectory: both train_rnr from one rnr_tpu checkpoint for 40
    iterations (TRAJ_ITERS), losses and the final validation.
"""

import ast
import importlib.util
import json
import os
import re
import shlex
import sys

import numpy as np
import pytest
import scipy.io

from rnr_tpu_torch.data.imageio import read_png
from rnr_tpu_torch.data.scene import make_scene
from rnr_tpu_torch.tools import quality_gate as gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tools", "out",
                         "quality_gate_canonical_r5.json")
BENCH_VARS = ("BENCH_CONV_BACKEND", "BENCH_RAYS_DTYPE", "BENCH_GCN_DTYPE",
              "BENCH_GCN_REFRESH", "BENCH_SH_FAN")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jgate():
    """rnr_tpu's tools/quality_gate.py, loaded from its file."""
    return _load("_rnr_tpu_quality_gate",
                 os.path.join(ROOT, "tools", "quality_gate.py"))


# ------------------------------------------------------- (a) the arms


def test_ablations_equal_rnr_tpus(jgate):
    assert gate.ABLATIONS == jgate.ABLATIONS
    for tag in jgate.ABLATIONS:
        assert gate.resolve_ablation(tag) == jgate.resolve_ablation(tag)


def test_ship_arm_on_the_repos_best_config(jgate, monkeypatch):
    for var in BENCH_VARS:
        monkeypatch.delenv(var, raising=False)
    sys.path.insert(0, ROOT)
    try:
        want = jgate.resolve_ablation("ship")
    finally:
        sys.path.remove(ROOT)
    assert gate.resolve_ablation("ship") == want
    pairs = dict(zip(want[::2], want[1::2]))
    with open(gate.TUNED_PATH) as f:
        assert pairs["--unet_conv_backend"] == json.load(f)["conv_backend"]


FILES = {"absent": None, "corrupt": "{not json",
         "pallas_bf16": {"conv_backend": "pallas", "rays_dtype": "bfloat16"},
         "refresh4": {"graph_refresh_every": 4, "sh_fan_fuse": False},
         "typo": {"conv_backend": "cudnn", "gcn_dtype": "f16",
                  "sh_fan_fuse": "maybe", "graph_refresh_every": 99}}
ENVS = {"none": {}, "conv_xla": {"BENCH_CONV_BACKEND": "xla"},
        "conv_bad": {"BENCH_CONV_BACKEND": "tpu"},
        "rays_f32": {"BENCH_RAYS_DTYPE": "float32"},
        "gcn_bf16": {"BENCH_GCN_DTYPE": "bfloat16"},
        "refresh2": {"BENCH_GCN_REFRESH": "2"},
        "refresh_junk": {"BENCH_GCN_REFRESH": "junk"},
        "fan_off": {"BENCH_SH_FAN": "0"}, "fan_typo": {"BENCH_SH_FAN": "x"}}


@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("file", sorted(FILES))
def test_ship_arm_resolves_as_bench(jgate, tmp_path, monkeypatch, file, env):
    """A copy of bench.py rooted in tmp_path beside the temporary
    best_config.json (tests/test_bench_config.py's fixture), imported as
    `bench` for rnr_tpu's resolve_ablation; the port reads the same
    file and the same BENCH_* variables."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        (tmp_path / "bench.py").write_text(f.read())
    out = tmp_path / "tools" / "out"
    out.mkdir(parents=True)
    content = FILES[file]
    if content is not None:
        (out / "best_config.json").write_text(
            content if isinstance(content, str) else json.dumps(content))
    for var in BENCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in ENVS[env].items():
        monkeypatch.setenv(var, value)
    bench = _load("bench", tmp_path / "bench.py")
    monkeypatch.setitem(sys.modules, "bench", bench)
    assert (gate.resolve_tuned_config(out / "best_config.json")
            == bench.resolve_tuned_config())
    assert (gate.resolve_ablation("ship", out / "best_config.json")
            == jgate.resolve_ablation("ship"))


# ------------------------------------------------- (b) the log roots


@pytest.mark.parametrize("iters,img,canonical,platform", [
    (2000, 512, True, None), (2000, 128, False, None), (4, 32, False, "cpu"),
    (50, 512, True, "cuda")])
def test_arm_log_root_is_rnr_tpus(jgate, iters, img, canonical, platform):
    import argparse
    ns = argparse.Namespace(iters=iters, img=img, canonical=canonical,
                            platform=platform)
    assert gate._gate_cfg(ns) == jgate._gate_cfg(ns)
    for tag in ("exact", "ship"):
        cfg = gate.arm_cfg(ns, tag)
        assert (gate._arm_log_root("/r", tag, cfg)
                == jgate._arm_log_root("/r", tag, cfg))


# ------------------------------------------------------ (c) the scene


def test_make_scene_writes_rnr_tpus_files(tmp_path):
    """The port's make_scene and tests/test_pipeline_e2e.py's (cv2's
    writes) at the gate's CPU size: the same file names, mesh.obj byte
    for byte, calib.mat's arrays, and every view and probe decoding to
    the same array."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from test_pipeline_e2e import make_scene as jmake_scene
    finally:
        sys.path.pop(0)
    a = jmake_scene(str(tmp_path / "jax"), num_view=5, hw=48, n_lat=9,
                    n_lon=14)
    b = make_scene(str(tmp_path / "port"), num_view=5, hw=48, n_lat=9,
                   n_lon=14)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, ns in os.walk(root) for n in ns)
    assert files(a) == files(b)
    assert len(files(a)) == 1 + 1 + 2 + 2 * 5
    with open(os.path.join(a, "mesh.obj"), "rb") as fa, \
            open(os.path.join(b, "mesh.obj"), "rb") as fb:
        assert fa.read() == fb.read()
    ca, cb = (scipy.io.loadmat(os.path.join(r, "calib.mat")) for r in (a, b))
    for k in ("poses", "projs", "dist_coeffs", "img_hws", "global_RT"):
        assert np.array_equal(ca[k], cb[k]), k
    for f in files(a):
        if f.endswith(".png"):
            x, y = (read_png(os.path.join(r, f)) for r in (a, b))
            assert x.shape == y.shape and np.array_equal(x, y), f
            assert x.max() > 0 or f.startswith("lp"), f


# ------------------------------------------------- (d) the tiny gate


def test_tiny_gate_end_to_end_and_resume(tmp_path, monkeypatch):
    """Two arms at --iters 4 --img 32 on the CPU, each in its own process:
    every arm's entry has rnr_tpu's keys (its canonical result's, val's
    final_* included) and the port's; the --out file merges them; a
    second call trains nothing (no subprocess); `compare` gives each arm
    a verdict against rnr_tpu's canonical result."""
    out, root = str(tmp_path / "gate.json"), str(tmp_path / "scene")
    argv = ["--platform", "cpu", "--iters", "4", "--img", "32",
            "--ablations", "ship,exact", "--out", out, "--root", root]
    res = gate.main(argv)
    with open(REFERENCE) as f:
        ref = json.load(f)
    with open(out) as f:
        written = json.load(f)
    assert set(res) == set(written) == {"ship", "exact"}
    for tag, entry in written.items():
        assert set(ref[tag]) <= set(entry), tag
        assert set(ref[tag]["val"]) == set(entry["val"]), tag
        assert entry["iters"] == 4 and entry["timing"]["iters_timed"] == 3
        assert np.isfinite([entry["first_loss"], entry["last_loss"],
                            *entry["val"].values()]).all()
        assert entry["iters_per_s"] == entry["timing"]["iters_per_s"] > 0
        assert entry["device"] == "cpu" and entry["peak_device_mib"] is None
        assert entry["peak_rss_mib"] > 0
        samples = entry["memory"]["samples"]
        assert len(samples) >= 2 and all(s[1] > 0 for s in samples)
    # the ship arm's flags are the shipped knobs'
    ship_root = gate._arm_log_root(root, "ship", gate.arm_cfg(
        gate.build_argparser().parse_args(argv), "ship"))
    with open(os.path.join(gate._latest_run(ship_root)[0],
                           "params.json")) as f:
        params = json.load(f)
    assert "pallas3" in json.dumps(params)

    def no_training(*a, **k):
        raise AssertionError("a resumed arm trained again")
    monkeypatch.setattr(gate.subprocess, "run", no_training)
    again = gate.main(argv)
    assert json.dumps(again, sort_keys=True) == json.dumps(
        {t: written[t] for t in ("ship", "exact")}, sort_keys=True)

    cmp = gate.compare(out, REFERENCE)
    assert set(cmp["arms"]) == {"ship", "exact"}
    assert all(r["verdict"] in ("pass", "miss") for r in cmp["arms"].values())
    # 4 iterations at 32^2 are not rnr_tpu's 2000 at 512^2
    assert cmp["arms"]["ship"]["metrics"]["last_loss"]["within"] is False


def test_compare_verdicts_and_limits():
    """rnr_tpu's canonical result against itself passes every arm with
    zero deltas; the limits are max(TOLERANCES, 3 x the seed spread)
    (SSIM: 3 x |0.8011 - 0.7700|); an arm moved past a limit misses."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    res = gate.compare(ref, REFERENCE)
    assert all(r["verdict"] == "pass" for r in res["arms"].values())
    spread = abs(ref["r5_fast"]["val"]["final_ssim"]
                 - ref["r5_fast_seed1"]["val"]["final_ssim"])
    assert res["limits"]["final_ssim"] == pytest.approx(3 * spread)
    assert res["limits"]["final_psnr"] == 0.10
    moved = json.loads(json.dumps(ref))
    moved["exact"]["val"]["final_psnr"] += 0.11
    moved["ship"]["last_loss"] *= 1.11
    moved["extra"] = {"iters": 1}
    res = gate.compare(moved, ref)
    assert res["arms"]["exact"]["verdict"] == "miss"
    assert res["arms"]["ship"]["verdict"] == "miss"
    assert res["arms"]["r5_fast"]["verdict"] == "pass"
    assert res["arms"]["extra"]["verdict"] == "no reference"


# ---------------------------------------------------- scripts, imports


SCRIPTS = ("preproc", "train_rnr", "test_rnr", "train_dnr", "test_dnr")


def _commands(path):
    """The script's assignments and `python -m` commands, continuation
    lines joined, each as its list of words."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    return [shlex.split(ln) for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_script_matches_the_original(name):
    """scripts/<name>_torch.sh: every line of scripts/<name>.sh with the
    same words, but the module (rnr_tpu.drivers.* ->
    rnr_tpu_torch.drivers.*) and the usage message's script name."""
    orig = _commands(os.path.join(ROOT, "scripts", f"{name}.sh"))
    port = _commands(os.path.join(ROOT, "scripts", f"{name}_torch.sh"))
    assert len(orig) == len(port) and orig
    n_python = 0
    for a, b in zip(orig, port):
        if a[:2] == ["python", "-m"]:
            n_python += 1
            assert b[:2] == ["python", "-m"]
            assert a[2].startswith("rnr_tpu.drivers.")
            assert b[2] == "rnr_tpu_torch" + a[2][len("rnr_tpu"):]
            assert a[3:] == b[3:]
        else:
            assert [w.replace(f"{name}.sh", f"{name}_torch.sh")
                    for w in a] == b
    assert n_python >= 1
    assert os.access(os.path.join(ROOT, "scripts", f"{name}_torch.sh"),
                     os.X_OK)


def test_gate_and_scene_import_no_bench_or_test_module():
    """rnr_tpu_torch/tools/ and data/scene.py import neither bench.py,
    rnr_tpu's tools, a test module, nor anything that
    test_torch_drivers.py's guard forbids (JAX, rnr_tpu, cv2, ...)."""
    from test_torch_drivers import FORBIDDEN_IMPORTS, _imports
    paths = [os.path.join(ROOT, "rnr_tpu_torch", "data", "scene.py")]
    tools = os.path.join(ROOT, "rnr_tpu_torch", "tools")
    paths += [os.path.join(tools, n) for n in os.listdir(tools)
              if n.endswith(".py")]
    assert len(paths) >= 3
    for path in paths:
        with open(path) as f:
            names = list(_imports(ast.parse(f.read(), path)))
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN_IMPORTS + ("bench", "tools",
                                                   "quality_gate", "tests",
                                                   "conftest"), (path, name)
            assert not re.match(r"test_", top), (path, name)


# ------------------------------------------------- (e) the trajectory

TRAJ_ITERS = 40


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """Both train_rnr.main on one scene precomputed and stitched by
    rnr_tpu (test_torch_drivers.py's 64^2 scene and flags), from one
    checkpoint that rnr_tpu's train_rnr wrote before its first step, in
    f32 on the plain conv route with the exact kNN, the stochastic GCN
    and (by test_torch_drivers.py's recorder) the U-Net's dropout off,
    for TRAJ_ITERS iterations with one validation at the last: each
    side's per-iteration losses and summary.json."""
    import rnr_tpu.train as jtrain_pkg
    from rnr_tpu.drivers import precompute as jpre
    from rnr_tpu.drivers import stitch_lp as jst
    from rnr_tpu.drivers import train_rnr as jtrain
    from rnr_tpu_torch.drivers import train_rnr
    from test_torch_drivers import TRAIN_ARGS, _recorder, _run_dir
    root = make_scene(str(tmp_path_factory.mktemp("traj")))
    jpre.main(["--data_root", root, "--img_size", "64",
               "--sampling_pattern", "all"])
    jst.main(["--data_root", root, "--sampling_pattern", "all",
              "--img_suffix", ".png", "--lp_h", "64", "--lp_w", "128"])
    args = [*TRAIN_ARGS, "--stochastic", "false", "--unet_compute_dtype",
            "float32", "--unet_conv_backend", "xla", "--knn_approx", "false",
            "--val_freq", str(TRAJ_ITERS - 1), "--log_freq", "1000",
            "--data_root", root]

    def logs(tag):
        return ["--logging_root", os.path.join(root, tag)]

    jtrain.main([*args, "--max_iter", "0", *logs("init")])
    ckpt = os.path.join(_run_dir(os.path.join(root, "init")),
                        "model_final.ckpt")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod, owner, extra in (
                ("jax", jtrain, jtrain_pkg, []),
                ("port", train_rnr, train_rnr, ["--platform", "cpu"])):
            rec = {"batches": [], "losses": [], "coeffs": []}
            mp.setattr(owner, "make_rnr_train_step", _recorder(
                owner.make_rnr_train_step, rec, tag == "port"))
            mod.main([*args, "--max_iter", str(TRAJ_ITERS), "--checkpoint",
                      ckpt, *extra, *logs(tag)])
            with open(os.path.join(_run_dir(os.path.join(root, tag)),
                                   "summary.json")) as f:
                out[tag] = (np.asarray(rec["losses"]), json.load(f))
    return out


def test_trajectory_losses_follow_rnr_tpu(trajectory):
    """Over 40 iterations from one checkpoint: the mean of each loss term
    over the last 10 iterations within 1e-4 of rnr_tpu's for the total
    (measured 1.5e-5 relative) and 2e-4 for the render term (measured
    3.3e-5); every iteration's render term within 1e-3 (measured 1.4e-4,
    the lockstep test's bound); the total falls from its second
    iteration (the albedo prior's first) to its last on both sides, by
    the same share to 1e-3.  The lighting term's mean parts by 0.7%
    (Adam's normalised steps on near-zero gradients,
    test_torch_drivers.py's lockstep test): reported, not held."""
    (j, js), (p, ps) = trajectory["jax"], trajectory["port"]
    print("rnr_tpu loss (total, rn) per iteration:")
    print(np.array2string(j[:, :2], precision=6))
    print("the port's:")
    print(np.array2string(p[:, :2], precision=6))
    assert j.shape == p.shape == (TRAJ_ITERS, 5)
    assert np.isfinite(p).all()
    jm, pm = j[-10:].mean(0), p[-10:].mean(0)
    rel = (pm - jm) / jm
    print("last-10 means (loss, rn, lighting, chrom, alb): rnr_tpu", jm,
          "port", pm, "relative", rel)
    assert abs(rel[0]) <= 1e-4 and abs(rel[1]) <= 2e-4, rel
    np.testing.assert_allclose(p[:, 1], j[:, 1], rtol=1e-3)
    assert j[-1, 0] < j[1, 0] and p[-1, 0] < p[1, 0]
    assert abs((p[-1, 0] / p[1, 0]) - (j[-1, 0] / j[1, 0])) <= 1e-3
    assert js["iters"] == ps["iters"] == TRAJ_ITERS
    assert js["last_loss"] == pytest.approx(ps["last_loss"], rel=1e-4)


def test_trajectory_final_validation_follows_rnr_tpu(trajectory):
    """The validation at the 40th iteration, every key of rnr_tpu's:
    final_psnr within 0.01 dB of rnr_tpu's (measured 4.3e-4),
    final_ssim within 1e-3 (measured 4.6e-5), final_mae within 0.01
    (measured 1.9e-3); the relit frames (the relight probe's SH fit)
    final_relight_psnr within 0.3 dB (measured 0.096: the weights'
    parting amplified under a lighting the run never trained on) and
    final_relight_ssim within 3e-3 (measured 6.2e-4)."""
    js, ps = trajectory["jax"][1], trajectory["port"][1]
    assert set(js["val"]) == set(ps["val"])
    for k, tol in (("final_psnr", 0.01), ("final_ssim", 1e-3),
                   ("final_mae", 0.01), ("final_relight_psnr", 0.3),
                   ("final_relight_ssim", 3e-3)):
        d = ps["val"][k] - js["val"][k]
        print(k, "rnr_tpu", js["val"][k], "port", ps["val"][k], "delta", d)
        assert abs(d) <= tol, (k, d)
