"""The DNR vertical of the port against rnr_tpu's, on the CPU.

- DNRModules from a carried-across rnr_tpu DNR state (f32, `xla` route,
  dropout off): a training step's loss to 1e-5 relative, its masked
  metrics to 1e-4 relative, every parameter gradient to 1e-4 of its
  largest value, and the eval frame to 1e-4 of its largest value; the
  port's own state trains (loss falls) and takes `texture_init`.
- Checkpoints: the port's format round trip and rnr_tpu's msgpack DNR
  TrainState read into the modules; DNRConfig's params.json read by
  both packages.
- The drivers on the 64^2 scene of tests/test_pipeline_e2e.py (each
  package precomputes its own copy): the port's train_dnr (4
  iterations) writes rnr_tpu's files and test_dnr renders its
  checkpoint; on the checkpoint rnr_tpu's train_dnr wrote, the port's
  test_dnr.main matches rnr_tpu's within one level of 255 on all but 1%
  of the pixels; make_spiral's calib.mat equals rnr_tpu's and test_dnr
  renders it through --calib_dir; --tex_fp reads as cv2 does; resuming
  with --checkpoint and --start_epoch; --synthetic as `python -m` with no
  jax, flax, rnr_tpu, cv2 or msgpack module loaded.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import rnr_tpu.config as jax_config
import rnr_tpu_torch.config as port_config
from rnr_tpu.train import steps as jsteps
from rnr_tpu_torch.convert import jax_grads_to_torch, load_jax_variables
from rnr_tpu_torch.data.imageio import (IMREAD_COLOR, read_image, read_png,
                                        write_png)
from rnr_tpu_torch.data.scene import make_scene
from rnr_tpu_torch.train import steps as psteps
from rnr_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from test_torch_drivers import FORBIDDEN, ROOT, _run_dir

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
S = 64


def _configs(compute_dtype="float32", conv_backend="xla"):
    """The 64^2 DNR configuration of tests/test_pipeline_e2e.py (texture
    64^2 x 16 channels, 2 levels, nf0 8, 5 downs), in both packages."""
    kw = dict(texture=dict(texture_size=S, texture_num_ch=16,
                           mipmap_level=2),
              render_net=dict(nf0=8, conv_backend=conv_backend,
                              compute_dtype=compute_dtype),
              train=dict(img_size=S))

    def build(mod):
        return mod.DNRConfig(
            texture=mod.TextureConfig(**kw["texture"]),
            render_net=mod.RenderNetConfig(**kw["render_net"]),
            train=mod.TrainConfig(**kw["train"]))
    return build(jax_config), build(port_config)


def _batch(seed=0, n=1):
    rng = np.random.default_rng(seed)
    alpha = (rng.uniform(size=(n, S, S, 1)) > 0.3).astype(np.float32)
    return {"uv_map": rng.uniform(0, 1, (n, S, S, 2)).astype(np.float32),
            "sh_basis_map": rng.uniform(-1, 1, (n, S, S, 9)).astype(
                np.float32),
            "alpha_map": alpha,
            "img_gt": rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32)}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def carried():
    """rnr_tpu's DNR state on a batch of two, its loss, metrics, gradients
    and eval frame (dropout off), and the port's modules with its
    variables."""
    jcfg, pcfg = _configs()
    nb = _batch(n=2)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    mods, state, _ = jsteps.create_dnr_state(jcfg, KEY, jb, 1e-3)

    def loss_fn(params):
        with nn.intercept_methods(_no_dropout):
            out, _ = jsteps.dnr_forward(mods, params, jb,
                                        rngs={"dropout": KEY}, train=True)
        loss = jsteps.image_l1_loss(out, jb["img_gt"], jb["alpha_map"],
                                    jcfg.loss.border_crop)
        return loss, out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params)
    b = jcfg.loss.border_crop
    a = jb["alpha_map"][:, b:-b, b:-b]
    metrics = jsteps.masked_err_metrics(
        out[:, b:-b, b:-b] * a * 255.0, jb["img_gt"][:, b:-b, b:-b] * a
        * 255.0, a)
    frame = jsteps.make_dnr_eval_step(jcfg, mods)(state, jb)
    pm = psteps.build_dnr_modules(pcfg, device="cpu")
    load_jax_variables(pm, {"params": jax.device_get(state.params)})
    return dict(jcfg=jcfg, pcfg=pcfg, batch=nb, state=state, mods=mods,
                loss=float(loss), grads=jax.device_get(grads),
                metrics={k: float(v) for k, v in metrics.items()},
                frame=np.asarray(frame), port=pm)


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def test_dnr_train_step_matches_rnr_tpu(carried):
    """One port step from rnr_tpu's state, dropout off: loss, masked
    metrics and every parameter gradient (the Adam update's input)."""
    pm, pcfg = carried["port"], carried["pcfg"]
    pm.render_net.Unet_0.use_dropout = False
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = psteps.create_rnr_optimizer(pm, 1e-3)
    step = psteps.make_dnr_train_step(pcfg, pm, opt)
    met = step(_torch_batch(carried["batch"]),
               psteps.make_generator(0, "cpu"))
    assert abs(float(met["loss"]) - carried["loss"]) <= 1e-5 * abs(
        carried["loss"])
    for k in ("mae_valid", "psnr_valid", "mse_valid"):
        want = carried["metrics"][k]
        assert abs(float(met[k]) - want) <= 1e-4 * abs(want), k
    want = jax_grads_to_torch(pm, carried["grads"])
    assert set(want) == {n for n, _ in pm.named_parameters()}
    for n, p in pm.named_parameters():
        scale = float(want[n].abs().max())
        assert scale > 0, n
        err = float((p.grad - want[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)
        assert not torch.equal(p.detach(), before[n]), n
    with torch.no_grad():   # back to rnr_tpu's weights for the frame
        for n, p in pm.named_parameters():
            p.copy_(before[n])


def test_dnr_eval_frame_matches_rnr_tpu(carried):
    pm, pcfg = carried["port"], carried["pcfg"]
    got = psteps.make_dnr_eval_step(pcfg, pm)(
        _torch_batch(carried["batch"])).numpy()
    want = carried["frame"]
    assert got.shape == want.shape == (2, S, S, 3)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_dnr_modules_carry_the_flax_tree_and_its_initialisers(carried):
    """The port's modules have the flax DNR state's parameters one for one
    (load_jax_variables leaves none over), its fresh draw has flax's
    initialisers (a conv kernel's std 1/sqrt(fan-in) within 10%, textures
    ones and 0.01, biases zero) and a different draw for another seed."""
    _, pcfg = _configs()
    a = psteps.init_dnr_params(psteps.build_dnr_modules(pcfg, device="cpu"),
                               0)
    b = psteps.init_dnr_params(psteps.build_dnr_modules(pcfg, device="cpu"),
                               1)
    jp = jax.device_get(carried["state"].params)
    for n, p in a.named_parameters():
        *path, leaf = n.split(".")
        want = jp
        for k in path + [leaf]:
            want = want[k]
        assert tuple(p.shape) == np.shape(want), n
        if leaf == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            assert abs(float(p.std()) * fan_in ** 0.5 - 1) < 0.1, n
            assert float(np.std(want)) * fan_in ** 0.5 == pytest.approx(
                1, abs=0.1), n
            assert not torch.equal(p, dict(b.named_parameters())[n]), n
        else:
            np.testing.assert_array_equal(p.detach().numpy(), want)


def test_dnr_train_loss_decreases():
    """tests/test_train.py's DNR case on the port: 10 steps at 32^2
    (texture 32 x 12 channels, 2 levels, nf0 8, 3 downs, crop 2, lr 2e-3,
    dropout on): finite, the last loss under 0.9 of the first."""
    cfg = port_config.DNRConfig(
        texture=port_config.TextureConfig(texture_size=32, texture_num_ch=12,
                                          mipmap_level=2),
        render_net=port_config.RenderNetConfig(nf0=8, num_down_unet=3),
        loss=port_config.LossConfig(border_crop=2),
        train=port_config.TrainConfig(lr=2e-3, img_size=32))
    rng = np.random.default_rng(0)
    batch = {"uv_map": rng.uniform(0, 1, (2, 32, 32, 2)),
             "sh_basis_map": rng.uniform(-1, 1, (2, 32, 32, 9)),
             "alpha_map": np.ones((2, 32, 32, 1)),
             "img_gt": rng.uniform(0, 1, (2, 32, 32, 3))}
    batch = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    mods, opt = psteps.create_dnr_state(cfg, 0, cfg.train.lr, device="cpu")
    step = psteps.make_dnr_train_step(cfg, mods, opt)
    gen = psteps.make_generator(0, "cpu")
    losses = [float(step(batch, gen)["loss"]) for _ in range(10)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    assert psteps.make_dnr_eval_step(cfg, mods)(batch).shape == (2, 32, 32,
                                                                 3)


def test_dnr_texture_init_matches_rnr_tpu():
    """create_dnr_state(texture_init=...) writes the image into level 0's
    first two channel blocks, as rnr_tpu's."""
    jcfg, pcfg = _configs()
    ti = np.random.default_rng(0).uniform(0, 1, (S, S, 3)).astype(
        np.float32)
    jb = {"uv_map": jnp.asarray(_batch()["uv_map"])}
    _, state, _ = jsteps.create_dnr_state(jcfg, KEY, jb, 1e-3,
                                          texture_init=ti)
    mods, _ = psteps.create_dnr_state(pcfg, 0, 1e-3, texture_init=ti,
                                      device="cpu")
    for level in range(2):
        want = np.asarray(state.params["texture_mapper"][f"texture_{level}"])
        got = getattr(mods.texture_mapper, f"texture_{level}").detach()
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ checkpoints


def test_dnr_checkpoint_formats(tmp_path, carried):
    """rnr_tpu's msgpack DNR TrainState (empty constants and spectral)
    read into the port's modules gives its params exactly; the port's
    own format round-trips the modules, the Adam state and the step."""
    jpath = str(tmp_path / "j.ckpt")
    from rnr_tpu.train.checkpoint import save_checkpoint as jsave
    jsave(jpath, carried["state"])
    _, pcfg = _configs()
    pm = psteps.build_dnr_modules(pcfg, device="cpu")
    assert load_checkpoint(jpath, pm) == 0
    want = jax_grads_to_torch(pm, jax.device_get(carried["state"].params))
    for n, p in pm.named_parameters():
        assert torch.equal(p.detach(), want[n]), n

    opt = psteps.create_rnr_optimizer(pm, 1e-3)
    pm.render_net.Unet_0.use_dropout = False
    psteps.make_dnr_train_step(pcfg, pm, opt)(
        _torch_batch(_batch(1)), psteps.make_generator(0, "cpu"))
    ppath = str(tmp_path / "p.ckpt")
    save_checkpoint(ppath, pm, opt, 7)
    back = psteps.build_dnr_modules(pcfg, device="cpu")
    opt2 = psteps.create_rnr_optimizer(back, 1e-3)
    assert load_checkpoint(ppath, back, opt2) == 7
    for (k, a), (k2, b) in zip(pm.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys() and len(s1) == len(list(pm.parameters()))
    for i in s1:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[i][k], s2[i][k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dnr_params_json_read_by_the_other_package(tmp_path, writer):
    jcfg, pcfg = _configs("bfloat16", "pallas3")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert port_config.from_dict(port_config.DNRConfig,
                                 dataclasses.asdict(jcfg)) == pcfg
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jax_config.save_config(jcfg, jpath)
    port_config.save_config(pcfg, ppath)
    assert open(jpath).read() == open(ppath).read()
    if writer == "jax":
        assert port_config.load_config(port_config.DNRConfig, jpath) == pcfg
    else:
        assert jax_config.load_config(jax_config.DNRConfig, ppath) == jcfg


# ---------------------------------------------------------------- drivers


TRAIN_ARGS = ["--obj_fp", "_/mesh.obj", "--img_size", "64",
              "--texture_size", "64", "--mipmap_level", "2", "--nf0", "8",
              "--texture_num_ch", "16", "--max_iter", "4", "--val_freq",
              "3", "--ckp_freq", "100", "--sampling_pattern", "all",
              "--sampling_pattern_val", "only_0"]
TEST_ARGS = ["--obj_fp", "_/mesh.obj", "--img_size", "64",
             "--sampling_pattern", "only_1"]


@pytest.fixture(scope="module")
def dnr_scenes(tmp_path_factory):
    """The 64^2 scene precomputed by rnr_tpu (first) and by the port
    (second), each in its own copy, and each package's train_dnr run (4
    iterations) on its own copy: (roots, run dirs)."""
    from rnr_tpu.drivers import precompute as jpre
    from rnr_tpu.drivers import train_dnr as jtrain
    from rnr_tpu_torch.drivers import precompute, train_dnr
    base = make_scene(str(tmp_path_factory.mktemp("dnr_scene")))
    roots, runs = [], []
    for tag, pre, train, extra in (("jax", jpre, jtrain, []),
                                   ("port", precompute, train_dnr,
                                    ["--platform", "cpu"])):
        root = str(tmp_path_factory.mktemp(f"dnr_{tag}"))
        shutil.copytree(base, root, dirs_exist_ok=True)
        pre.main(["--data_root", root, "--img_size", "64",
                  "--sampling_pattern", "all", *extra])
        out = train.main(["--data_root", root, "--logging_root",
                          os.path.join(root, "logs"), *TRAIN_ARGS, *extra])
        run = _run_dir(os.path.join(root, "logs"))
        if tag == "port":
            assert out[0] == run
            assert next(out[1].parameters()).device.type == "cpu"
        roots.append(root)
        runs.append(run)
    return roots, runs


def test_train_dnr_artifacts(dnr_scenes):
    """rnr_tpu's files: params.json (read by rnr_tpu's load_config),
    model_final.ckpt, summary.json (4 iterations, finite losses), the
    val_* directories and the one validation's PNG."""
    _, (_, run) = dnr_scenes
    for f in ("params.json", "model_final.ckpt", "summary.json"):
        assert os.path.isfile(os.path.join(run, f)), f
    for sub in ("val_out", "val_gt", "val_err"):
        assert os.path.isdir(os.path.join(run, sub)), sub
    assert os.listdir(os.path.join(run, "val_out")) == [
        "00000003_00000.png"]
    with open(os.path.join(run, "summary.json")) as f:
        summary = json.load(f)
    assert summary["iters"] == 4
    assert np.isfinite([summary["first_loss"], summary["last_loss"]]).all()
    cfg = jax_config.load_config(jax_config.DNRConfig,
                                 os.path.join(run, "params.json"))
    assert (cfg.texture.texture_num_ch, cfg.render_net.nf0) == (16, 8)


def _test_dnr(root, run, out_dir, *extra, port=True, **kw):
    if port:
        from rnr_tpu_torch.drivers import test_dnr
        extra = (*extra, "--platform", "cpu")
    else:
        from rnr_tpu.drivers import test_dnr
    return test_dnr.main(["--data_root", root, "--checkpoint_dir", run,
                          *TEST_ARGS, "--out_dir", out_dir, *extra], **kw)


def test_test_dnr_renders_the_ports_checkpoint(dnr_scenes):
    """The port's test_dnr.main on its own train_dnr's checkpoint: one
    64^2 PNG for the view, equal to the frame it returns, black off the
    object."""
    (_, root), (_, run) = dnr_scenes
    out = os.path.join(run, "render")
    res = _test_dnr(root, run, out, keep_frames=True)
    assert res["views"] == 1 and os.listdir(out) == ["000001.png"]
    img = read_png(os.path.join(out, "000001.png"))
    assert img.shape == (64, 64, 3) and img.max() > 0 and img[0, 0].max() == 0
    frame = res["frames"]["000001"].numpy()
    want = (np.clip(frame, 0, 1) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(img, want)


def test_test_dnr_on_rnr_tpu_checkpoint_matches_rnr_tpu(dnr_scenes):
    """The checkpoint and params.json of rnr_tpu's train_dnr (msgpack),
    rendered by both packages' test_dnr.main (each U-Net in f32, whatever
    the config's compute_dtype): within one level of 255 on all but 1% of
    the pixels, within 4 levels everywhere."""
    (jroot, _), (jrun, _) = dnr_scenes
    pj = _test_dnr(jroot, jrun, os.path.join(jrun, "j_out"), port=False)
    pp = _test_dnr(jroot, jrun, os.path.join(jrun, "p_out"))
    assert pj is None and pp["views"] == 1
    a = read_png(os.path.join(jrun, "j_out", "000001.png")).astype(int)
    b = read_png(os.path.join(jrun, "p_out", "000001.png")).astype(int)
    d = np.abs(a - b).max(-1)
    assert a.max() > 0
    assert (d > 1).mean() <= 0.01 and d.max() <= 4, ((d > 1).mean(),
                                                      d.max())


def test_make_spiral_matches_rnr_tpu_and_test_dnr_renders_it(dnr_scenes):
    """Both packages' make_spiral (3 steps) on the scene: the same
    calib.mat; the port's test_dnr renders it through --calib_dir."""
    from rnr_tpu.drivers import make_spiral as jspiral
    from rnr_tpu_torch.drivers import make_spiral
    (_, root), (_, run) = dnr_scenes
    args = ["--data_root", root, "--num_step", "3"]
    jspiral.main([*args, "--out_dir", "_/spiral_jax"])
    path = make_spiral.main([*args, "--out_dir", "_/spiral_port"])
    assert path == os.path.join(root, "spiral_port", "calib.mat")
    a = scipy.io.loadmat(os.path.join(root, "spiral_jax", "calib.mat"))
    b = scipy.io.loadmat(path)
    for k in ("poses", "projs", "dist_coeffs", "img_hws", "global_RT"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = os.path.join(run, "spiral")
    from rnr_tpu_torch.drivers import test_dnr
    res = test_dnr.main(["--data_root", root, "--checkpoint_dir", run,
                         "--obj_fp", "_/mesh.obj", "--img_size", "64",
                         "--calib_dir", "_/spiral_port", "--out_dir", out,
                         "--checkpoint_name", "model_final.ckpt",
                         "--platform", "cpu"])
    assert res["views"] == 3 and len(os.listdir(out)) == 3


def test_train_dnr_resumes_from_a_checkpoint(dnr_scenes, capsys):
    """--checkpoint (the port's file, then rnr_tpu's) with --start_epoch
    1: the iteration counter starts at one epoch's views (6) and the run
    ends at --max_iter; model_iter-8.ckpt is written at --ckp_freq 4."""
    (jroot, root), (jrun, run) = dnr_scenes
    from rnr_tpu_torch.drivers import train_dnr
    for src in (run, jrun):
        logs = os.path.join(root, "logs_resume" + ("_j" if src == jrun
                                                   else ""))
        args = [a for a in TRAIN_ARGS]
        args[args.index("--max_iter") + 1] = "9"
        args[args.index("--ckp_freq") + 1] = "4"
        args += ["--log_freq", "10"]
        log_dir, _ = train_dnr.main([
            "--data_root", root, "--logging_root", logs, *args,
            "--checkpoint", os.path.join(src, "model_final.ckpt"),
            "--start_epoch", "1", "--platform", "cpu"])
        txt = capsys.readouterr().out
        assert "restored checkpoint" in txt and "Iter 0000006" in txt
        assert "Iter 0000005" not in txt
        with open(os.path.join(log_dir, "summary.json")) as f:
            assert json.load(f)["iters"] == 9
        assert os.path.isfile(os.path.join(log_dir, "model_iter-8.ckpt"))


def test_tex_fp_reads_as_rnr_tpu(tmp_path):
    """train_dnr's --tex_fp: an 8-bit RGB PNG, a 16-bit RGBA PNG, a gray
    PNG, an RGB JPEG, a gray JPEG and a JPEG with EXIF orientation 6 read
    and INTER_AREA-resized as rnr_tpu's cv2 path does (to float32
    rounding); the JPEGs read bit-equal to cv2's default read."""
    import cv2
    from rnr_tpu_torch.drivers.train_dnr import read_texture_init
    rng = np.random.default_rng(0)
    imgs = {"rgb8": rng.integers(0, 256, (40, 52, 3)).astype(np.uint8),
            "rgba16": rng.integers(0, 65536, (33, 30, 4)).astype(np.uint16),
            "gray": rng.integers(0, 256, (20, 24)).astype(np.uint8)}
    paths = []
    for name, img in imgs.items():
        paths.append(str(tmp_path / f"{name}.png"))
        write_png(paths[-1], img)
    for name in ("rgb8", "gray"):
        paths.append(str(tmp_path / f"{name}.jpg"))
        cv2.imwrite(paths[-1], imgs[name])
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = 6
    paths.append(str(tmp_path / "exif6.jpg"))
    Image.fromarray(imgs["rgb8"]).save(paths[-1], exif=exif.tobytes())
    for path in paths:
        name = os.path.basename(path)
        tex = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        want = cv2.resize(tex, (16, 16), interpolation=cv2.INTER_AREA
                          ).astype(np.float32) / 255.0
        got = read_texture_init(path, 16)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5 / 255, )
        assert np.mean(np.abs(got - want) > 1e-6) <= 0.05, name
        if path.endswith(".jpg"):
            assert np.array_equal(read_image(path, IMREAD_COLOR), tex)


def test_train_dnr_synthetic_runs_as_a_module_without_jax(tmp_path):
    """`python -m rnr_tpu_torch.drivers.train_dnr --synthetic --platform
    cpu` in a fresh interpreter: it trains, validates, checkpoints, and
    no jax, flax, rnr_tpu, cv2 or msgpack module is loaded."""
    code = f"""
import runpy, sys
sys.path.insert(0, {ROOT!r})
sys.argv = ["train_dnr", "--synthetic", "--platform", "cpu",
            "--logging_root", {str(tmp_path)!r}, "--img_size", "32",
            "--texture_size", "32", "--mipmap_level", "2", "--nf0", "8",
            "--texture_num_ch", "12", "--max_iter", "3", "--val_freq", "2",
            "--log_freq", "1", "--ckp_freq", "2"]
runpy.run_module("rnr_tpu_torch.drivers.train_dnr", run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("FOREIGN", bad)
assert not bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    run = _run_dir(str(tmp_path))
    for f in ("params.json", "model_final.ckpt", "model_iter-2.ckpt",
              "summary.json"):
        assert os.path.isfile(os.path.join(run, f)), f
    assert len(os.listdir(os.path.join(run, "val_out"))) == 2
