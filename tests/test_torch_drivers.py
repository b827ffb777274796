"""The port's offline workflow against rnr_tpu's, end to end on the 64^2
scene of tests/test_pipeline_e2e.py (the port's copy of its make_scene,
rnr_tpu_torch/data/scene.py):

  precompute -> stitch_lp -> train_rnr (4 iterations) -> test_rnr.main

run once by each package's drivers on its own copy of the scene (the
port on the CPU, `--platform cpu`).  Held:
- the datasets: ViewDataset (with the precomputed maps) and
  LightProbeDataset of the same files read by both packages, equal;
- precompute: the winner maps agree on >= 99.9% of the pixels (ties only
  between faces that share an edge), alpha and front masks equal, the
  weights and every map at the agreeing pixels within the G-buffer
  tests' 8 u M witness (tests/test_torch_gbuffer.py);
- stitch_lp: masks differ on at most 1% of the probe pixels (cv2's fill
  and 8-bit resizes against the port's, on the object's edge), the
  stitched probe equal wherever both cover it with the same pixels;
- train_rnr: params.json, model_final.ckpt, summary.json (4 iterations,
  a finite loss), every val_* directory and the tensorboard tags;
- test_rnr.main: learned0/000002.png with and without --per_stage_timing
  (all eight buckets printed), novel probes through SH and the gather;
  and on the checkpoint that rnr_tpu's train_rnr wrote, frames within
  one level of 255 of rnr_tpu's test_rnr.main on all but a stated share.
Also: --synthetic training run as `python -m` in a fresh interpreter, the
refusals of the unported flags, and no module of the port importing jax,
flax, rnr_tpu, cv2 or msgpack.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch

from rnr_tpu_torch.data.imageio import read_image, read_png
from rnr_tpu_torch.data.scene import make_scene

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rnr_tpu", "cv2", "msgpack")
# no module of the port imports an image package either (tensorboardX,
# which the drivers use where it is installed, imports PIL itself)
FORBIDDEN_IMPORTS = FORBIDDEN + ("PIL", "imageio")


TRAIN_ARGS = [
    "--obj_high_fp", "_/mesh.obj", "--obj_low_fp", "_/mesh.obj",
    "--obj_gcn_fp", "_/mesh.obj", "--img_size", "64", "--texture_size",
    "64", "--mipmap_level", "2", "--nf0", "8", "--n_blocks", "2",
    "--n_filters", "8", "--kernel_size", "4", "--out_channels_gcn", "16",
    "--sh_lmax", "2", "--sphere_samples_fp", "nonexistent.mat",
    "--lighting_idx", "0", "--lighting_relight_idx", "1", "--lp_dir",
    "_/lp", "--max_iter", "4", "--val_freq", "3", "--ckp_freq", "100",
    "--log_freq", "2", "--sampling_pattern", "all",
    "--sampling_pattern_val", "only_0"]
TEST_ARGS = ["--obj_high_fp", "_/mesh.obj", "--obj_gcn_fp", "_/mesh.obj",
             "--img_size", "64", "--sampling_pattern", "only_2",
             "--sphere_samples_fp", "nonexistent.mat"]


def _run_dir(log_root):
    runs = sorted(os.listdir(log_root))
    assert runs
    return os.path.join(log_root, runs[-1])


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The scene, precomputed and stitched by rnr_tpu (first) and by the
    port (second), each in its own copy."""
    from rnr_tpu.drivers import precompute as jpre
    from rnr_tpu.drivers import stitch_lp as jst
    from rnr_tpu_torch.drivers import precompute, stitch_lp
    base = make_scene(str(tmp_path_factory.mktemp("scene")))
    roots = []
    for tag, pre, st, extra in (("jax", jpre, jst, []),
                                ("port", precompute, stitch_lp,
                                 ["--platform", "cpu"])):
        root = str(tmp_path_factory.mktemp(tag))
        shutil.copytree(base, root, dirs_exist_ok=True)
        pre.main(["--data_root", root, "--img_size", "64",
                  "--sampling_pattern", "all", *extra])
        st.main(["--data_root", root, "--sampling_pattern", "all",
                 "--img_suffix", ".png", "--lp_h", "64", "--lp_w", "128"])
        roots.append(root)
    return roots


@pytest.fixture(scope="module")
def trained(scenes):
    """(rnr_tpu's run dir, the port's run dir): 4 iterations each."""
    from rnr_tpu.drivers import train_rnr as jtrain
    from rnr_tpu_torch.drivers import train_rnr
    jroot, proot = scenes
    jtrain.main(["--data_root", jroot, "--logging_root",
                 os.path.join(jroot, "logs"), *TRAIN_ARGS])
    log_dir, model = train_rnr.main([
        "--data_root", proot, "--logging_root", os.path.join(proot, "logs"),
        *TRAIN_ARGS, "--platform", "cpu"])
    assert log_dir == _run_dir(os.path.join(proot, "logs"))
    assert next(model.parameters()).device.type == "cpu"
    return _run_dir(os.path.join(jroot, "logs")), log_dir


LOSS_KEYS = ("loss", "loss_rn", "loss_lighting", "loss_rays_lt_chrom",
             "loss_alb")
LOCKSTEP_ITERS = 6


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _recorder(make_step, rec, port):
    """make_rnr_train_step wrapped so that the U-Net's dropout is off (the
    two packages draw it from different generators) and every step's
    batch and losses and, at the first step, the statics and the
    lighting coefficients are recorded as NumPy."""
    import flax.linen as nn

    def host(tree):
        return {k: np.array(v.detach().cpu() if port else v)
                for k, v in tree.items()}

    def make(model, *args, **kw):
        if port:
            model.render_net.Unet_0.use_dropout = False
        step = make_step(model, *args, **kw)

        def run(*a):
            batch, statics = (a[0], a[1]) if port else (a[1], a[2])
            if not rec["batches"]:
                rec["statics"] = host(statics)
            rec["coeffs"].append(np.array(
                model.lighting.coeff.detach() if port
                else a[0].params["lighting"]["coeff"]))
            rec["batches"].append(host(batch))
            if port:
                out = step(*a)
            else:
                with nn.intercept_methods(_no_dropout):
                    out = step(*a)
            metrics = out if port else out[1]
            rec["losses"].append([float(metrics[k]) for k in LOSS_KEYS])
            return out
        return run
    return make


@pytest.fixture(scope="module")
def lockstep(scenes):
    """Both train_rnr.main on rnr_tpu's copy of the scene (its precompute
    and stitch), the stochastic GCN and the U-Net's dropout off, and the
    U-Net in f32 on the plain conv route with the exact kNN (each package
    rounds a bf16 U-Net at its own places; the shipped knobs are held
    frame by frame below), for
    LOCKSTEP_ITERS iterations from one checkpoint that rnr_tpu's
    train_rnr wrote before its first step (--max_iter 0: the weights of
    its initialisers and Adam's zero moments).  Each side's record of
    every step, and the port's own step-0 checkpoint (--max_iter 0, no
    --checkpoint) for its initial lighting."""
    import rnr_tpu.train as jtrain_pkg
    from rnr_tpu.drivers import train_rnr as jtrain
    from rnr_tpu_torch.drivers import train_rnr
    jroot = scenes[0]
    args = [*TRAIN_ARGS, "--stochastic", "false", "--unet_compute_dtype",
            "float32", "--unet_conv_backend", "xla", "--knn_approx", "false",
            "--val_freq", "100", "--log_freq", "1", "--data_root", jroot]

    def logs(tag):
        return ["--logging_root", os.path.join(jroot, tag)]

    jtrain.main([*args, "--max_iter", "0", *logs("lock_init_jax")])
    ckpt = os.path.join(_run_dir(os.path.join(jroot, "lock_init_jax")),
                        "model_final.ckpt")
    port_init, _ = train_rnr.main([*args, "--max_iter", "0", "--platform",
                                   "cpu", *logs("lock_init_port")])
    recs = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod, owner, extra in (
                ("jax", jtrain, jtrain_pkg, []),
                ("port", train_rnr, train_rnr, ["--platform", "cpu"])):
            rec = recs[tag] = {"batches": [], "losses": [], "coeffs": []}
            mp.setattr(owner, "make_rnr_train_step", _recorder(
                owner.make_rnr_train_step, rec, tag == "port"))
            mod.main([*args, "--max_iter", str(LOCKSTEP_ITERS),
                      "--checkpoint", ckpt, *extra, *logs(f"lock_{tag}")])
    return recs, ckpt, os.path.join(port_init, "model_final.ckpt"), jroot


# ------------------------------------------------------------- datasets


def test_view_and_probe_datasets_match_rnr_tpu(scenes):
    """Both packages' ViewDataset (the precomputed maps of rnr_tpu's
    precompute included) and LightProbeDataset on the same files: every
    key of every view and probe equal."""
    from rnr_tpu.data import LightProbeDataset as JLP
    from rnr_tpu.data import ViewDataset as JVD
    from rnr_tpu_torch.data import LightProbeDataset, ViewDataset
    root = scenes[0]
    kw = dict(root_dir=root, calib_path=os.path.join(root, "calib.mat"),
              img_dir=os.path.join(root, "rgb0"), img_size=(64, 64),
              sampling_pattern="skip_2", load_precompute=True,
              precomp_high_dir=os.path.join(root, "precomp_mesh"),
              precomp_low_dir=os.path.join(root, "precomp_mesh"),
              img_gamma=2.2)
    j, t = JVD(**kw), ViewDataset(**kw)
    j.buffer_all()
    t.buffer_all()
    assert len(t) == len(j) == 3 and t.keep_idx == j.keep_idx
    for a, b in zip(j.views_all, t.views_all):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    jl = JLP(os.path.join(root, "lp"), img_gamma=2.2)
    tl = LightProbeDataset(os.path.join(root, "lp"), img_gamma=2.2)
    assert len(tl) == len(jl) == 2
    for i in range(2):
        assert np.array_equal(tl[i]["lp_img"], jl[i]["lp_img"])
    j = JVD(**dict(kw, load_img=False, load_precompute=False, img_dir=None))
    t = ViewDataset(**dict(kw, load_img=False, load_precompute=False,
                           img_dir=None))
    for i in range(len(j)):
        a, b = j.read_view(i), t.read_view(i)
        assert set(a) == set(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_batch_loader_collate_and_prefetch_match_rnr_tpu(scenes):
    """BatchLoader's shuffled batches (the same NumPy stream), collate_views
    and the prefetch thread (items in order, a source's error raised in
    the consumer) as rnr_tpu's."""
    from rnr_tpu.data import BatchLoader as JBL
    from rnr_tpu.data import ViewDataset as JVD
    from rnr_tpu.data import collate_views as jcollate
    from rnr_tpu.data.prefetch import prefetch as jprefetch
    from rnr_tpu_torch.data import BatchLoader, ViewDataset, collate_views
    from rnr_tpu_torch.data.prefetch import prefetch
    root = scenes[1]
    kw = dict(root_dir=root, calib_path=os.path.join(root, "calib.mat"),
              img_dir=os.path.join(root, "rgb0"), img_size=(64, 64))
    j, t = JVD(**kw), ViewDataset(**kw)
    j.buffer_all()
    t.buffer_all()
    for drop_last in (True, False):
        jb = list(JBL(j, 4, seed=3, drop_last=drop_last))
        tb = list(BatchLoader(t, 4, seed=3, drop_last=drop_last))
        assert [[v["img_fn"] for v in b] for b in tb] == [
            [v["img_fn"] for v in b] for b in jb]
        for a, b in zip(jb, tb):
            ca, cb = (jcollate(a, ["img_gt", "proj"]),
                      collate_views(b, ["img_gt", "proj"]))
            assert all(np.array_equal(ca[k], cb[k]) for k in ca)
    assert list(prefetch(range(7), transform=lambda x: 2 * x)) == list(
        jprefetch(range(7), transform=lambda x: 2 * x))

    def failing():
        yield 1
        raise KeyError("source")

    with pytest.raises(KeyError, match="source"):
        list(prefetch(failing()))


# ----------------------------------------------------------- precompute


def test_precompute_matches_rnr_tpu(scenes):
    """Every view's files: raster maps and per-pixel maps against
    rnr_tpu's under the G-buffer tests' witness, the PNGs (alpha, img_gt)
    and the camera files equal."""
    import jax
    import jax.numpy as jnp

    import rnr_tpu.ops.gbuffer as jg
    from rnr_tpu.data.obj import Mesh as JaxMesh
    from rnr_tpu_torch.data import Mesh, ViewDataset
    from rnr_tpu_torch.ops import gbuffer as tg
    from test_torch_gbuffer import (_f64_weights, _hold_maps, _shared_edge,
                                    _witness)
    jroot, proot = scenes
    jres = os.path.join(jroot, "precomp_mesh", "resol_64")
    pres = os.path.join(proot, "precomp_mesh", "resol_64")
    assert sorted(os.listdir(jres)) == sorted(os.listdir(pres))
    ds = ViewDataset(proot, os.path.join(proot, "calib.mat"), (64, 64),
                     img_dir=os.path.join(proot, "rgb0"))
    mesh = Mesh(os.path.join(proot, "mesh.obj"), global_RT=np.eye(4))
    jmesh = jg.make_mesh_buffers(JaxMesh(os.path.join(jroot, "mesh.obj"),
                                         global_RT=np.eye(4)))
    for i in range(len(ds)):
        stem = "%06d" % i
        view = ds[i]
        args = [view["proj"][None], view["pose"][None],
                view["dist_coeffs"][None, :5]]

        def mat(res, sub, key):
            return scipy.io.loadmat(os.path.join(res, sub, stem + ".mat"))[
                key]

        rj = scipy.io.loadmat(os.path.join(jres, "raster", stem + ".mat"))
        rt = scipy.io.loadmat(os.path.join(pres, "raster", stem + ".mat"))
        fw, fg = rj["face_index_map"], rt["face_index_map"]
        agree = fg == fw
        assert agree.mean() >= 0.999
        for y, x in np.argwhere(~agree):
            assert _shared_edge(mesh.v, fg[y, x], fw[y, x], mesh.f_v_idx)
        assert np.array_equal(rt["v_front_mask"], rj["v_front_mask"])
        assert np.array_equal(rt["faces_v_idx"], rj["faces_v_idx"])
        faces_got = tg.project_faces(
            tg.make_mesh_buffers(mesh, "cpu"),
            *[torch.from_numpy(np.asarray(a, np.float32)) for a in args],
            None, None, 64)[1].numpy()
        faces_want = np.asarray(jax.jit(lambda *a: jg._project_and_raster(
            jmesh, *a, None, None, 64, 0.0, 1e5, 128, "xla")[1])(
                *map(jnp.asarray, args)))
        _, w64_got, u_m = _f64_weights(faces_got, fg[None], 64)
        _, w64_want, _ = _f64_weights(faces_want, fg[None], 64)
        _witness(rt["weight_map"][None, ..., 0], rj["weight_map"][None, ..., 0],
                 w64_got, w64_want, u_m, (agree & (fg >= 0))[None])
        keys = ("uv_map", "normal_map", "normal_map_cam", "position_map",
                "position_map_cam", "view_dir_map", "view_dir_map_cam",
                "view_dir_map_tangent", "sh_basis_map", "reflect_dir_map",
                "TBN_map")
        want = {k: mat(jres, k, k)[None] for k in keys}
        want.update(weight_map=rj["weight_map"][None],
                    v_uvz=rj["v_uvz"][None])
        got = {k: torch.from_numpy(mat(pres, k, k)[None]) for k in keys}
        got.update(weight_map=torch.from_numpy(rt["weight_map"][None]),
                   v_uvz=torch.from_numpy(rt["v_uvz"][None]))
        _hold_maps(got, want, agree[None], u_m)
        for sub in ("alpha_map", "img_gt"):
            assert np.array_equal(
                read_png(os.path.join(pres, sub, stem + ".png")),
                read_png(os.path.join(jres, sub, stem + ".png"))), sub
        for sub, key in (("proj", "proj"),):
            assert np.array_equal(mat(pres, sub, key), mat(jres, sub, key))
        for key in ("pose", "proj_orig"):
            assert np.array_equal(
                scipy.io.loadmat(os.path.join(proot, "precomp_mesh", "pose",
                                              stem + ".mat"))[key],
                scipy.io.loadmat(os.path.join(jroot, "precomp_mesh", "pose",
                                              stem + ".mat"))[key])


# ------------------------------------------------------------- stitch_lp


def test_stitch_lp_matches_rnr_tpu(scenes):
    """The coverage masks differ on at most 1% of the probe's pixels
    (measured 0.02%: the object's edge in the views, cv2's fillPoly and
    8-bit resizes against the port's); where both cover a pixel with the
    same count the stitched values agree on at least 97% of those
    pixels: the port's f32 `0.exr` within 1e-6 + 1e-2 of the largest
    channel of rnr_tpu's float stitch (its `.exr`, or the RGBE `.hdr`
    where its cv2 has no OpenEXR), else the two 8-bit `.png`; every view
    was used on both sides."""
    jroot, proot = scenes
    jd = os.path.join(jroot, "light_probe_stitch_all")
    pd = os.path.join(proot, "light_probe_stitch_all")
    for d in (jd, pd):
        for f in ("0.png", "mask/0.png", "count/0.png", "count/0.mat"):
            assert os.path.isfile(os.path.join(d, f)), (d, f)
    assert os.path.isfile(os.path.join(pd, "0.exr"))
    assert not os.path.isfile(os.path.join(pd, "0.hdr"))
    cj = scipy.io.loadmat(os.path.join(jd, "count", "0.mat"))
    cp = scipy.io.loadmat(os.path.join(pd, "count", "0.mat"))
    assert cj["num_view"].item() == cp["num_view"].item() == 6
    mj = read_png(os.path.join(jd, "mask", "0.png"))
    mp = read_png(os.path.join(pd, "mask", "0.png"))
    assert (mj != mp).any(-1).mean() <= 0.01
    same = (cj["count"] == cp["count"]) & (cp["count"] > 0)
    floats = [f for f in ("0.exr", "0.hdr")
              if os.path.isfile(os.path.join(jd, f))]
    ej = (read_image(os.path.join(jd, floats[0])) if floats
          else read_png(os.path.join(jd, "0.png")) / 255.0)
    ep = (read_image(os.path.join(pd, "0.exr")) if floats
          else read_png(os.path.join(pd, "0.png")) / 255.0)
    close = np.abs(ej - ep).max(-1) <= 1e-6 + 1e-2 * np.abs(ej).max(-1)
    assert close[same].mean() >= 0.97


# -------------------------------------------------------------- train_rnr


def test_train_rnr_artifacts(trained):
    _, log_dir = trained
    for f in ("params.json", "model_final.ckpt", "summary.json"):
        assert os.path.isfile(os.path.join(log_dir, f)), f
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    assert summary["iters"] == 4
    assert np.isfinite(summary["first_loss"]) and np.isfinite(
        summary["last_loss"])
    assert np.isfinite(summary["val"]["final_ssim_valid"])
    for sub in ("val_out", "val_err", "val_gt", "val_relight_out",
                "val_relight_err", "val_relight_gt"):
        assert os.listdir(os.path.join(log_dir, sub)), sub


def test_train_rnr_tensorboard_tags(trained):
    """The scalars and image grids of rnr_tpu's run, the lighting-
    estimation ones included (the probes give a lighting ground truth)."""
    _, log_dir = trained
    try:
        from tensorboard.backend.event_processing import event_accumulator
    except ImportError:
        pytest.skip("tensorboard reader unavailable")
    events = [f for f in os.listdir(log_dir)
              if f.startswith("events.out.tfevents")]
    assert events, "no tensorboard event file"
    tags = set()
    for ev in events:
        acc = event_accumulator.EventAccumulator(os.path.join(log_dir, ev))
        acc.Reload()
        tags |= set(acc.Tags().get("scalars", []))
        tags |= set(acc.Tags().get("images", []))
    for t in ("lighting_sh_coeff_mae", "lp_psnr_valid", "final_ssim_valid_val",
              "output_final_vs_gt", "lp_init_est_gt", "loss",
              "final_relight_ssim_valid_val", "relight_final_est_gt"):
        assert t in tags, (t, tags)


def test_train_rnr_params_json_reads_in_rnr_tpu(trained):
    """The port's params.json is rnr_tpu's config of the same flags."""
    import rnr_tpu.config as jc
    jdir, pdir = trained
    a = jc.load_config(jc.RNRConfig, os.path.join(jdir, "params.json"))
    b = jc.load_config(jc.RNRConfig, os.path.join(pdir, "params.json"))
    assert a == b


def test_train_rnr_step_inputs_match_rnr_tpu(lockstep):
    """What each driver hands its training step on the same scene: the
    lighting anchors sampled from the stitched probe (l_samples_init to
    f32 rounding, l_samples_mask equal), the albedo-prior anchor of the
    same checkpoint's texture, every step's batch (the view order and
    make_rnr_batch) equal; and the initial SH lighting of a fresh run
    (the probes' SH fit with the stitch's fit in lighting_idx's row) to
    f32 rounding of the two fits (1e-5 of the largest coefficient)."""
    from rnr_tpu_torch.train.checkpoint import read_flax_state
    import jax.numpy as jnp

    from rnr_tpu.ops.interpolate import interpolate_bilinear
    from rnr_tpu.ops.spherical import spherical_mapping
    from rnr_tpu_torch.drivers.common import load_sphere_samples
    from rnr_tpu_torch.drivers.train_rnr import _read_stitch, _sample_probe
    recs, ckpt, port_init, jroot = lockstep
    j, p = recs["jax"], recs["port"]
    assert set(p["statics"]) == set(j["statics"])
    np.testing.assert_allclose(p["statics"]["l_samples_init"],
                               j["statics"]["l_samples_init"],
                               rtol=1e-6, atol=1e-7)
    mj, mp = j["statics"]["l_samples_mask"], p["statics"]["l_samples_mask"]
    assert 0 < mp.mean() < 1
    # the mask is `== 1` of a bilinear sample of the 0/1 coverage: where
    # the four texels are covered, an acos one ulp apart in the two math
    # libraries can leave one side at 0.99999994 (measured: 1 sample of
    # 4096); every such sample is within 2 ulp of 1 on both sides
    off = np.flatnonzero(mj != mp)
    assert len(off) <= 0.001 * len(mj), len(off)
    if len(off):
        _, cover = _read_stitch(os.path.join(jroot, "light_probe_stitch_all"),
                                0, 2.2)
        l_dir = load_sphere_samples("nonexistent.mat")
        uv = np.asarray(spherical_mapping(jnp.asarray(l_dir)))
        x = np.clip(uv[0] * cover.shape[1], None, cover.shape[1] - 1)
        y = np.clip(uv[1] * cover.shape[0], None, cover.shape[0] - 1)
        want = np.asarray(interpolate_bilinear(
            jnp.asarray(cover), jnp.asarray(x), jnp.asarray(y)))[off, 0]
        got = _sample_probe(cover, l_dir)[off, 0]
        assert np.array_equal(want == 1, mj[off] == 1)
        assert np.array_equal(got == 1, mp[off] == 1)
        assert np.abs(np.stack([want, got]) - 1).max() <= 1.2e-7
    np.testing.assert_allclose(p["statics"]["tex_flatten_init"],
                               j["statics"]["tex_flatten_init"],
                               rtol=1e-6, atol=1e-7)
    assert len(p["batches"]) == len(j["batches"]) == LOCKSTEP_ITERS
    for a, b in zip(j["batches"], p["batches"]):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    want = read_flax_state(ckpt)["params"]["lighting"]["coeff"]
    got = torch.load(port_init, map_location="cpu")["model"]["lighting.coeff"]
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(p["coeffs"][0], j["coeffs"][0])


def test_train_rnr_losses_match_rnr_tpu_from_one_checkpoint(lockstep):
    """Both drivers from one rnr_tpu checkpoint, same inputs, nothing
    random: the first two iterations' loss terms within 1e-3 of rnr_tpu's
    (measured 6e-4: the lighting term after the first Adam step); every
    iteration's render term within 1e-3 (measured 8e-5) and every term
    within 2e-3 of that iteration's total loss (measured 9e-4: after the
    second step Adam's normalised updates of near-zero gradients part the
    two runs, the chrom and lighting terms by up to 2%).  Both show the
    albedo prior switching on after the first step: 0 while no texel has
    moved (its mask of changed texels is empty), then about 1, the
    distance of the touched texels' mean albedo (about 1, the texture
    starts at ones) from 0.5 over the diffuse and the specular halves."""
    recs = lockstep[0]
    j = np.asarray(recs["jax"]["losses"])
    p = np.asarray(recs["port"]["losses"])
    print("rnr_tpu losses (loss, rn, lighting, chrom, alb) per iteration:")
    print(np.array2string(j, precision=8))
    print("the port's:")
    print(np.array2string(p, precision=8))
    assert j.shape == p.shape == (LOCKSTEP_ITERS, len(LOSS_KEYS))
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p[:2], j[:2], rtol=1e-3, atol=1e-6)
    rn = LOSS_KEYS.index("loss_rn")
    np.testing.assert_allclose(p[:, rn], j[:, rn], rtol=1e-3)
    assert (np.abs(p - j) <= 2e-3 * j[:, :1]).all(), np.abs(p - j) / j[:, :1]
    alb = LOSS_KEYS.index("loss_alb")
    assert j[0, alb] == p[0, alb] == 0
    assert (np.abs(p[1:, alb] - 1) < 0.05).all()


# --------------------------------------------------------------- test_rnr


def _test_rnr(root, ckpt_dir, out_dir, *extra, port=True, capsys=None):
    if port:
        from rnr_tpu_torch.drivers import test_rnr
        args = [*extra, "--platform", "cpu"]
    else:
        from rnr_tpu.drivers import test_rnr
        args = list(extra)
    test_rnr.main(["--data_root", root, "--checkpoint_dir", ckpt_dir,
                   *TEST_ARGS, "--out_dir", out_dir, *args])
    return out_dir


@pytest.mark.parametrize("staged", [False, True])
def test_test_rnr_renders_learned_lighting(scenes, trained, capsys, staged):
    """learned0/000002.png under --lighting_type train, and with
    --per_stage_timing (and the probe composited behind the object) all
    eight buckets printed."""
    _, pdir = trained
    out = _test_rnr(scenes[1], pdir, os.path.join(pdir, f"render_{staged}"),
                    *(["--lighting_idx", "0", "--per_stage_timing", "true",
                       "--save_img_bg", "true"]
                      if staged else ["--lighting_type", "train"]))
    txt = capsys.readouterr().out
    buckets = ("t_prep", "t_raster", "t_network_render")
    if staged:
        buckets += ("t_preproc", "t_sh", "t_texture", "t_rays", "t_network",
                    "t_render")
    for b in buckets:
        assert f" {b} " in txt, b
    img = read_png(os.path.join(out, "learned0", "000002.png"))
    assert img.shape == (64, 64, 3) and img.max() > 0


def test_test_rnr_novel_light_sh_vs_probe(scenes, trained):
    """Novel probes through the SH fit (with the reference aliases) and
    through the gather: the same render to the low-order fit's tolerance
    (rnr_tpu's bound: mean difference under 0.05)."""
    _, pdir = trained
    outs = {}
    for mode in ("true", "false"):
        out = _test_rnr(
            scenes[1], pdir, os.path.join(pdir, f"render_lp_{mode}"),
            "--lp_dir", "_/lp", "--lp_sh", mode,
            "--per_stage_timing", "1" if mode == "true" else "0",
            *(["--lighting_type", "SH", "--sh_lmax", "2", "--gpu_id", "0,1"]
              if mode == "true" else []))
        img = read_png(os.path.join(out, "novel00", "000002.png"))
        assert img.max() > 0
        outs[mode] = img.astype(np.float32) / 255.0
    assert np.abs(outs["true"] - outs["false"]).mean() < 0.05


def test_test_rnr_on_rnr_tpu_checkpoint_matches_rnr_tpu(scenes, trained):
    """The checkpoint and params.json that rnr_tpu's train_rnr wrote
    (msgpack; the shipped bf16 U-Net, which each package rounds at its
    own places; bf16 kNN ranking, whose ties each breaks its own way),
    rendered by both packages' test_rnr.main under the learned lightings
    and the novel probes' SH fits: every frame within one level of 255
    of rnr_tpu's on all but 1% of the pixels, and within 4 levels
    everywhere (measured: 0-0.44% and 2 levels)."""
    jroot, _ = scenes
    jdir, _ = trained
    for extra in ([], ["--lp_dir", "_/lp"]):
        tag = "lp" if extra else "learned"
        pj = _test_rnr(jroot, jdir, os.path.join(jdir, f"j_{tag}"), *extra,
                       port=False)
        pp = _test_rnr(jroot, jdir, os.path.join(jdir, f"p_{tag}"), *extra)
        names = sorted(os.listdir(pj))
        assert names == sorted(os.listdir(pp)) and names
        for name in names:
            a = read_png(os.path.join(pj, name, "000002.png")).astype(int)
            b = read_png(os.path.join(pp, name, "000002.png")).astype(int)
            d = np.abs(a - b).max(-1)
            assert a.max() > 0
            assert (d > 1).mean() <= 0.01 and d.max() <= 4, (
                name, (d > 1).mean(), d.max())


# ------------------------------------------------- entry points, imports


def test_train_rnr_synthetic_runs_as_a_module_without_jax(tmp_path):
    """`python -m rnr_tpu_torch.drivers.train_rnr --synthetic --platform
    cpu` in a fresh interpreter, its batches assembled by the prefetch
    thread (--device_view_buffer off): it trains, validates and writes
    its files, and no jax, flax, rnr_tpu, cv2 or msgpack module is
    loaded."""
    code = f"""
import runpy, sys
sys.path.insert(0, {ROOT!r})
sys.argv = ["train_rnr", "--synthetic", "--platform", "cpu",
            "--logging_root", {str(tmp_path)!r}, "--img_size", "32",
            "--texture_size", "32", "--mipmap_level", "2", "--nf0", "8",
            "--n_blocks", "2", "--n_filters", "8", "--kernel_size", "4",
            "--out_channels_gcn", "16", "--sh_lmax", "2", "--max_iter", "3",
            "--val_freq", "2", "--log_freq", "1", "--ckp_freq", "2",
            "--sphere_samples_fp", "nonexistent.mat",
            "--device_view_buffer", "off"]
runpy.run_module("rnr_tpu_torch.drivers.train_rnr", run_name="__main__")
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
    assert os.listdir(os.path.join(run, "val_out"))
    with open(os.path.join(run, "summary.json")) as f:
        assert json.load(f)["iters"] == 3


def test_step_timer_and_trace_context(tmp_path):
    """StepTimer on the CPU times by the host clock and summarises as
    rnr_tpu's; trace_context writes a Chrome trace of its scope."""
    from rnr_tpu.utils.trace import StepTimer as JStepTimer
    from rnr_tpu_torch.utils.trace import StepTimer, trace_context
    timer = StepTimer("cpu")
    for _ in range(4):
        with timer.measure():
            torch.ones(64).sum()
    assert len(timer.times) == 4 and min(timer.times) >= 0
    j = JStepTimer()
    j.times = list(timer.times)
    assert timer.summary() == j.summary()
    with trace_context(str(tmp_path)):
        torch.ones(8).cumsum(0)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("name", ["precompute", "stitch_lp", "train_rnr",
                                  "test_rnr", "train_dnr", "test_dnr",
                                  "make_spiral"])
def test_drivers_take_rnr_tpu_flags(name):
    """Every flag of rnr_tpu's build_argparser, with its default, but
    --platform: the port's takes cuda (the default) or cpu (make_spiral,
    on the host, has none in either package)."""
    import importlib
    jp = importlib.import_module(f"rnr_tpu.drivers.{name}").build_argparser()
    tp = importlib.import_module(
        f"rnr_tpu_torch.drivers.{name}").build_argparser()

    def flags(p):
        return {a.dest: (a.option_strings, a.default, a.choices)
                for a in p._actions if a.dest != "help"}

    jf, tf = flags(jp), flags(tp)
    assert set(tf) == set(jf)
    for dest in jf:
        if dest == "platform":
            assert tf[dest][1] == "cuda"
            continue
        assert tf[dest] == jf[dest], dest
    if name == "train_rnr":
        assert len(tf) == 77


@pytest.mark.parametrize("flag", [["--mesh_devices", "2"],
                                  ["--coordinator_address", "h:1",
                                   "--num_processes", "2",
                                   "--process_id", "0"],
                                  ["--mesh_devices", "4", "--mesh_dp", "2"]])
def test_train_rnr_refuses_what_is_not_ported(flag, tmp_path):
    """Image rows across devices (rnr_tpu's sp: --mesh_dp below the
    ranks' count, 1 by default) run where the frame's rows are a multiple
    of 2**num_down with at least 2 innermost rows a rank
    (test_torch_sp.py); 96 rows (3 units of 32) do not split over sp 2
    with train_rnr's 5 downs, which raises before any rank starts, and
    so before the coordinator's rendezvous."""
    from rnr_tpu_torch.drivers import train_rnr
    with pytest.raises(ValueError, match=r"at least 2 \* sp \* 2\*\*num_down"):
        train_rnr.main(["--synthetic", "--platform", "cpu", "--img_size",
                        "96", "--logging_root", str(tmp_path), *flag])


def test_drivers_need_a_card_unless_asked_for_the_cpu():
    """--platform cuda (the default) raises without a card, and an
    unknown platform raises: nothing falls back to the CPU."""
    from rnr_tpu_torch.drivers.common import setup_device
    assert setup_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        setup_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_device("cuda")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_port_module_imports_jax_flax_rnr_tpu_cv2_or_msgpack():
    """Every import statement of every module of rnr_tpu_torch, at the top
    or inside a function, and chip_smoke.py's: none of FORBIDDEN_IMPORTS
    (JAX and its libraries, rnr_tpu, cv2, msgpack, PIL, imageio)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "rnr_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for name in ("train_dnr", "test_dnr", "make_spiral"):
        assert os.path.join(ROOT, "rnr_tpu_torch", "drivers",
                            name + ".py") in files, name
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imports(tree):
            assert name.split(".")[0] not in FORBIDDEN_IMPORTS, (path, name)
